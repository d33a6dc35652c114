"""The port's copy of ``fastdfs_tpu/common/jumphash.py``.

Jump consistent hash (Lamping & Veach, "A Fast, Minimal Memory,
Consistent Hash Algorithm", arXiv:1406.2294).

The parallel download path uses it to pick WHICH replica serves WHICH
byte range of a file: the function is stateless and consistent, so every
client maps (file id, range index) to the same replica — per-replica
hot-chunk read caches (storage.conf:read_cache_mb) accumulate hits
instead of each client spraying every replica's cache with every range.
When the replica set grows by one, only ~1/n of the range assignments
move (the consistent-hash property), so cache warmth largely survives
membership changes.
"""

from __future__ import annotations

import hashlib

_MASK64 = (1 << 64) - 1
_K = 2862933555777941757  # the paper's 64-bit LCG multiplier


def jump_hash(key: int, num_buckets: int) -> int:
    """Bucket in [0, num_buckets) for a 64-bit key — the paper's
    ch(key, num_buckets), bit-for-bit."""
    if num_buckets <= 0:
        raise ValueError(f"num_buckets must be positive, got {num_buckets}")
    key &= _MASK64
    b, j = -1, 0
    while j < num_buckets:
        b = j
        key = (key * _K + 1) & _MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def placement_key(key: str) -> int:
    """64-bit jump-hash key for upload placement (store_lookup = 3): the
    first 8 bytes (big-endian) of SHA1(client key).  Mirrored bit-exactly
    by native/common/jumphash.h PlacementKey (fdfs_codec placement-wire
    golden)."""
    h = hashlib.sha1(key.encode()).digest()
    return int.from_bytes(h[:8], "big")


def group_for_key(key: str, num_active_groups: int) -> int:
    """Index into the placement epoch's ordered ACTIVE-group list for one
    client key — the pick the tracker, the rebalance migrator, and a
    placement-routing client all agree on."""
    return jump_hash(placement_key(key), num_active_groups)


def range_key(file_id: str, range_index: int) -> int:
    """64-bit jump-hash key for one byte range of one file: the first 8
    bytes (big-endian) of SHA1("<file_id>#<range_index>")."""
    h = hashlib.sha1(f"{file_id}#{range_index}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def replica_for_range(file_id: str, range_index: int,
                      num_replicas: int) -> int:
    """Which replica (index into the tracker's query_fetch_all list)
    serves this range — the cache-affinity pick every client agrees on."""
    return jump_hash(range_key(file_id, range_index), num_replicas)
