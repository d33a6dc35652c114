"""Content-defined chunking via a gear rolling hash, position-parallel.

The port of ``fastdfs_tpu/ops/gear_cdc.py``, in two halves:

- **Host half** (NumPy, copied from the reference): the gear table, the
  spec and policy constants, the thread-local staging pool, greedy cut
  selection (``select_cuts``, ``select_cuts_skipmin``), the tiled host
  scan (``gear_hashes_np``, ``gear_candidates_np``, ``chunk_stream_np``)
  and the serial referees (``chunk_stream_ref``,
  ``chunk_stream_skipmin_ref``).  The storage daemon's own chunker shares
  this table, so ``DEDUP_FINGERPRINT_CUTS`` cuts equal these.
- **Device half**: ``chunk_stream``, which serves ``DEDUP_FINGERPRINT``
  (the sidecar chunks the segment itself), is ``upload_padded`` then
  ``device_cuts``; the client's fingerprint calls the two itself so that
  its SHA-1 launch reads the same device buffer.  ``device_cuts`` takes
  the candidates from ``ops.cuda_gear.gear_candidates_cuda``, the CUDA
  kernel ``csrc/gear_cdc.cu`` on a card.  This module keeps the plain
  PyTorch twins of that kernel's two forms, ``gear_candidates`` and
  ``block_candidates``, and ``gear_hashes``.  The reference runs these
  passes as XLA, not as a Pallas kernel.

The serial gear hash is ``h = (h << 1) + gear[b[i]]`` with a cut candidate
wherever ``h & mask == 0``.  Because ``<< 1`` pushes a byte's contribution
out of a 32-bit register after 32 steps, ``h`` at position ``i`` depends
only on the trailing 32-byte window:

    h[i] = sum_{k=0..31} gear[b[i-k]] << k        (mod 2^32)

which is computable independently per position (five shifted adds by
prefix doubling).  Cut-point equality with the serial algorithm (which
resets the hash at each chunk start) holds whenever ``min_size >= 32``.
The only sequential part is greedy cut selection over the sparse
candidate list, on the host.  Skip-min (``CDC_POLICY_SKIPMIN``) is the
opt-in policy with its own referee; see the reference module.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from fastdfs_tpu_torch.ops import MASK32, mul32, narrow
from fastdfs_tpu_torch.ops.cuda_gear import gear_candidates_cuda


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer: the gear table's generator."""
    x = np.asarray(x, dtype=np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


# Chunker spec version: bumped whenever cut-point behavior changes (the
# table, window, or selection rule).  v2 = the fmix32 table (round 5).
# Dedup state built under another spec chunks the same content at
# different offsets, so exact-dedup hits would silently drop to ~0; the
# sidecar discards stale-spec state at load (reads/recipes are
# unaffected — chunk stores are content-addressed).
CDC_SPEC_VERSION = 2

# Cut-selection policies.  Policy is orthogonal to the spec version: the
# DEFAULT policy under spec v2 is frozen (golden-pinned), and SKIPMIN is
# a distinct, explicitly-chosen policy with different boundaries — state
# built under one policy must never be queried under the other (the
# sidecar discards snapshots on policy mismatch, like spec mismatch).
CDC_POLICY_DEFAULT = 1   # serial-equivalent rolling evaluation (frozen)
CDC_POLICY_SKIPMIN = 2   # skip min_size bytes after each cut (arXiv:2508.05797)

# Deterministic 256-entry gear table, defined as fmix32(byte+1) so it is
# computable as well as storable: the device half evaluates it inline
# (no gather); the host paths and the C++ chunker use the materialized
# table.  Every node chunks identically.
GEAR_TABLE = _fmix32(np.arange(1, 257, dtype=np.uint32))

WINDOW = 32
_HALO = WINDOW - 1

# Reusable host staging buffers, thread-local: concurrent fingerprint
# calls must not share staging.
_staging = threading.local()


def staging_buffer(size: int, slot: int = 0) -> np.ndarray:
    """Reusable host staging buffer, keyed by (size, slot).

    ``slot`` keeps independent users of one size apart (the tiled host
    scan's two work buffers use their own slots).
    """
    bufs = getattr(_staging, "bufs", None)
    if bufs is None:
        bufs = _staging.bufs = {}
    key = (size, slot)
    buf = bufs.get(key)
    if buf is None:
        buf = bufs[key] = np.zeros(size, dtype=np.uint8)
    return buf


def staging_buffer_stats() -> dict:
    """Introspection for the growth audit: count + total bytes of live
    staging buffers on THIS thread (tests assert reuse, not realloc)."""
    bufs = getattr(_staging, "bufs", None) or {}
    return {
        "buffers": len(bufs),
        "bytes": int(sum(b.nbytes for b in bufs.values())),
        "keys": sorted(bufs.keys()),
    }


# Default chunking geometry (bytes).  avg 8 KiB => 13 mask bits.
DEFAULT_MIN_SIZE = 2048
DEFAULT_AVG_BITS = 13
DEFAULT_MAX_SIZE = 65536


def gear_hashes_ref(data: bytes | np.ndarray) -> np.ndarray:
    """Serial CPU reference: windowed gear hash at every position."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    out = np.zeros(len(buf), dtype=np.uint32)
    h = np.uint32(0)
    with np.errstate(over="ignore"):
        for i, b in enumerate(buf):
            h = np.uint32(h << np.uint32(1)) + GEAR_TABLE[b]
            out[i] = h
    return out


# -- device half (plain PyTorch) ---------------------------------------------

def gear_values(data: torch.Tensor) -> torch.Tensor:
    """Gear table values as inline fmix32 arithmetic (no gather): uint8
    -> int64 in [0, 2**32)."""
    x = data.to(torch.int64) + 1
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gear_window(g: torch.Tensor) -> torch.Tensor:
    """Windowed gear hashes of int64 gear values ``g`` along the last
    axis, with zeros before the first value: int64 in [0, 2**32).

    Prefix doubling: S_w[i] = sum_{k<w} g[i-k] << k satisfies
    S_2w[i] = S_w[i] + (S_w[i-w] << w), so the 32-term window needs
    log2(32) = 5 shifted adds, not 31.  ``block_candidates`` passes a
    block's values with its predecessor's trailing 31 in front.

    Every eager gear pass (``gear_hashes``, ``gear_candidates``,
    ``block_candidates``) runs through here; ``gear_window.cuda_calls``
    counts those on a CUDA tensor, which the card's paths leave to the
    kernel.
    """
    if g.device.type == "cuda":
        gear_window.cuda_calls += 1
    h = g
    n = h.shape[-1]
    w = 1
    while w < WINDOW:
        shifted = torch.zeros_like(h)
        if w < n:
            shifted[..., w:] = h[..., :-w]
        h = (h + (shifted << w)) & MASK32
        w <<= 1
    return h


gear_window.cuda_calls = 0


def _gear_hashes(data: torch.Tensor) -> torch.Tensor:
    return gear_window(gear_values(data))


def gear_hashes(data: torch.Tensor) -> torch.Tensor:
    """Position-parallel gear hashes of uint8 ``(n,)`` data: uint32 ``(n,)``
    equal to the serial rolling value at every position, on the data's
    device."""
    return narrow(_gear_hashes(torch.as_tensor(data, dtype=torch.uint8)))


def candidate_mask(hashes: torch.Tensor, avg_bits: int = DEFAULT_AVG_BITS
                   ) -> torch.Tensor:
    """Boolean cut-candidate mask of int64 hashes: positions where the low
    ``avg_bits`` bits are zero (expected chunk size ``2**avg_bits``)."""
    return (hashes & ((1 << avg_bits) - 1)) == 0


def gear_candidates(data: torch.Tensor, n: int, avg_bits: int, k: int
                    ) -> torch.Tensor:
    """The first ``k`` candidate positions within the first ``n`` bytes,
    sorted and padded with ``len(data)``, computed and compacted on the
    data's device, then the number of candidates below ``n`` (more than
    ``k`` where the positions were cut short): int64 ``(k + 1,)``.  The
    reference returns the ``(k,)`` positions alone.

    The plain twin of the compacted form of ``csrc/gear_cdc.cu``
    (``ops.cuda_gear.gear_candidates_cuda``).  Compaction is a prefix sum
    plus a scatter, so the output has a fixed size and nothing waits on
    the host until the caller fetches it.
    """
    size = data.shape[0]
    pos = torch.arange(size, device=data.device)
    m = candidate_mask(_gear_hashes(data), avg_bits) & (pos < n)
    rank = torch.cumsum(m, 0) - 1
    slot = torch.where(m & (rank < k), rank, k)     # k = discard slot
    out = torch.full((k + 1,), size, dtype=torch.int64, device=data.device)
    out.scatter_(0, slot, pos)
    out[k] = m.sum()
    return out


def block_candidates(g: torch.Tensor, halo: torch.Tensor,
                     avg_bits: int) -> torch.Tensor:
    """Cut candidates of one block: int64 gear values ``g`` (B, L) and the
    gear values of the 31 bytes before it ``halo`` (B, 31) -> bool (B, L),
    equal to the whole stream's ``candidate_mask`` at these positions.

    The plain twin of the dense form of ``csrc/gear_cdc.cu``
    (``ops.cuda_gear.block_candidates_cuda``, which takes the bytes)."""
    h = gear_window(torch.cat([halo, g], dim=1))[:, _HALO:]
    return (h & ((1 << avg_bits) - 1)) == 0


def select_cuts(
    candidates: np.ndarray,
    n: int,
    min_size: int = DEFAULT_MIN_SIZE,
    max_size: int = DEFAULT_MAX_SIZE,
) -> list[int]:
    """Greedy cut selection under min/max chunk-size constraints.

    ``candidates`` are sorted candidate positions (cut *after* byte ``i``,
    i.e. chunk end ``i + 1``).  Returns exclusive end offsets of every chunk
    (final offset is ``n``).  Sequential but sparse — O(#cuts log #cands) on
    the host.
    """
    if min_size < WINDOW:
        raise ValueError(f"min_size must be >= {WINDOW} for cut-point "
                         f"equality with the serial reference")
    cuts: list[int] = []
    cand = np.asarray(candidates, dtype=np.int64)
    last = 0
    while n - last > max_size or (n - last >= min_size and len(cand)):
        lo = np.searchsorted(cand, last + min_size - 1, side="left")
        hi = np.searchsorted(cand, last + max_size - 1, side="right")
        if lo < hi:
            cut = int(cand[lo]) + 1
        elif n - last > max_size:
            cut = last + max_size
        else:
            break
        cuts.append(cut)
        last = cut
    if last < n:
        cuts.append(n)
    return cuts


def select_cuts_skipmin(
    data: bytes | np.ndarray,
    candidates: np.ndarray,
    n: int,
    min_size: int = DEFAULT_MIN_SIZE,
    avg_bits: int = DEFAULT_AVG_BITS,
    max_size: int = DEFAULT_MAX_SIZE,
) -> list[int]:
    """Skip-min cut selection from precomputed *windowed* candidates.

    Skip-min restarts the hash at the first eligible position after each
    cut (``last + min_size - 1``), so the hash at position ``p`` covers
    ``[start, p]`` clamped to the 32-byte window.  For
    ``p >= start + WINDOW - 1`` the window is full and the restart hash
    EQUALS the continuous windowed hash — the global candidate list
    applies verbatim.  Only the ``<= 31`` warm-up positions per chunk
    (partial windows) need fresh hashing, done vectorized on the slice.

    Needs the byte buffer (for warm-up hashing) in addition to the
    candidate list.  ``candidates`` must cover ``[0, n)`` densely (every
    windowed-hash candidate), as produced by ``gear_candidates`` /
    ``gear_candidates_np``.
    """
    if min_size < 1:
        raise ValueError("min_size must be >= 1")
    if max_size < min_size:
        raise ValueError("max_size must be >= min_size")
    buf = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    mask = np.uint32((1 << avg_bits) - 1)
    cand = np.asarray(candidates, dtype=np.int64)
    cuts: list[int] = []
    last = 0
    while n - last > 0:
        if n - last < min_size:
            cuts.append(n)
            break
        start = last + min_size - 1       # first position a cut may land on
        forced = last + max_size - 1      # reaching this position always cuts
        cutpos = -1
        # Warm-up region: partial-window restart hashes, <= 31 positions.
        warm_end = min(start + WINDOW - 2, forced, n - 1)
        if warm_end >= start:
            wh = gear_hashes_np(buf[start:warm_end + 1])
            hits = np.nonzero((wh & mask) == 0)[0]
            if len(hits):
                cutpos = start + int(hits[0])
        if cutpos < 0:
            # Full-window region: reuse the global windowed candidates.
            lo = np.searchsorted(cand, start + WINDOW - 1, side="left")
            hi = np.searchsorted(cand, min(forced, n - 1), side="right")
            if lo < hi:
                cutpos = int(cand[lo])
        if cutpos >= 0:
            cuts.append(cutpos + 1)
            last = cutpos + 1
        elif n - last >= max_size:
            cuts.append(last + max_size)
            last = last + max_size
        else:
            cuts.append(n)
            break
    return cuts


def chunk_stream(
    data: bytes,
    min_size: int = DEFAULT_MIN_SIZE,
    avg_bits: int = DEFAULT_AVG_BITS,
    max_size: int = DEFAULT_MAX_SIZE,
    cdc_policy: int = CDC_POLICY_DEFAULT,
    _k_override: int | None = None,
    device: str | torch.device = "cuda",
) -> list[int]:
    """Device-parallel CDC: returns exclusive chunk end offsets for ``data``.

    The buffer is zero-padded to the next power of two (at least 4 KiB),
    as in the reference; trailing padding cannot affect ``h[i]`` for real
    positions.  Only the sparse candidate list leaves the device (fetched
    with 4x headroom over the expected density); if a pathological input
    exceeds the headroom, the pass runs again with room for every
    candidate, so the cuts stay exact.  ``_k_override`` lets tests force
    that recovery.

    ``cdc_policy``: ``CDC_POLICY_DEFAULT`` is cut-identical to
    ``chunk_stream_ref``; ``CDC_POLICY_SKIPMIN`` to
    ``chunk_stream_skipmin_ref``.  Both share one hash pass.
    """
    if cdc_policy not in (CDC_POLICY_DEFAULT, CDC_POLICY_SKIPMIN):
        raise ValueError(f"unknown cdc_policy {cdc_policy}")
    if not data:
        return []
    host, dev = upload_padded(data, device)
    return device_cuts(host, dev, len(data), min_size, avg_bits, max_size,
                       cdc_policy, _k_override)


def _cdc_len(n: int) -> int:
    """The device pass's buffer length: the next power of two, >= 4 KiB."""
    return 1 << max(12, (n - 1).bit_length())


def upload_padded(data: bytes, device: str | torch.device, slack: int = 0
                  ) -> tuple[np.ndarray, torch.Tensor]:
    """``data`` copied once onto ``device``, zero past its end up to the
    device pass's power-of-two length plus ``slack`` bytes.

    ``slack`` lets a kernel that loads a little past the last chunk
    (``ops.SEGMENT_SLACK``) share this buffer with the CDC pass even when
    ``len(data)`` is itself a power of two.  Returns this thread's host
    staging, valid until its next call, and the device buffer.  On a
    card the staging is pinned (``_pinned_staging``) and the copy runs
    from it without blocking the host; on the CPU the two share memory.
    """
    n = len(data)
    size = _cdc_len(n) + slack
    dev = torch.device(device)
    pinned = _pinned_staging(size) if dev.type == "cuda" else None
    buf = staging_buffer(size) if pinned is None else pinned.numpy()
    buf[:n] = np.frombuffer(data, dtype=np.uint8)
    buf[n:] = 0
    if pinned is None:
        return buf, torch.from_numpy(buf).to(dev)
    out = pinned.to(dev, non_blocking=True)
    _pinned.uploaded = torch.cuda.Event()
    _pinned.uploaded.record(torch.cuda.current_stream(dev))
    return buf, out


_pinned = threading.local()


def _pinned_staging(size: int) -> torch.Tensor:
    """This thread's pinned host staging, as the engine keeps one: the
    first ``size`` bytes of a buffer grown to the largest size asked for,
    handed out only after the previous upload from it has landed."""
    if getattr(_pinned, "uploaded", None) is not None:
        _pinned.uploaded.synchronize()
        _pinned.uploaded = None
    buf = getattr(_pinned, "buf", None)
    if buf is None or buf.shape[0] < size:
        buf = _pinned.buf = torch.empty(size, dtype=torch.uint8,
                                        pin_memory=True)
    return buf[:size]


def device_cuts(host: np.ndarray, dev: torch.Tensor, n: int,
                min_size: int = DEFAULT_MIN_SIZE,
                avg_bits: int = DEFAULT_AVG_BITS,
                max_size: int = DEFAULT_MAX_SIZE,
                cdc_policy: int = CDC_POLICY_DEFAULT,
                _k_override: int | None = None) -> list[int]:
    """``chunk_stream``'s cuts of the ``n`` bytes that ``upload_padded``
    staged as ``host`` and ``dev`` (``n >= 1``), from the candidates of
    ``gear_candidates_cuda`` (the kernel on a card, its plain twin on the
    CPU), on the stream that staged ``dev``."""
    if cdc_policy not in (CDC_POLICY_DEFAULT, CDC_POLICY_SKIPMIN):
        raise ValueError(f"unknown cdc_policy {cdc_policy}")
    padded = _cdc_len(n)
    dev = dev[:padded]
    k = _k_override if _k_override is not None else max(
        padded >> max(avg_bits - 2, 0), 256)
    out = gear_candidates_cuda(dev, n, avg_bits, k).cpu().numpy()
    count = int(out[k])
    if count > k:
        # More candidates than slots (>4x the expected density): run the
        # pass again with a slot for each, rather than miss a cut point.
        out = gear_candidates_cuda(dev, n, avg_bits, count).cpu().numpy()
    cand = out[:count]
    if cdc_policy == CDC_POLICY_SKIPMIN:
        return select_cuts_skipmin(host[:n], cand, n, min_size, avg_bits,
                                   max_size)
    return select_cuts(cand, n, min_size, max_size)


def gear_hashes_np(data: bytes | np.ndarray) -> np.ndarray:
    """Vectorized NumPy twin of :func:`gear_hashes` (same prefix-doubling
    windowed sum, uint32 wraparound), for host-side chunking without a
    per-byte Python loop (``gear_hashes_ref``)."""
    buf = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    with np.errstate(over="ignore"):
        x = buf.astype(np.uint32) + np.uint32(1)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        h = x ^ (x >> np.uint32(16))
        w = 1
        while w < WINDOW:
            shifted = np.zeros_like(h)
            shifted[w:] = h[:-w]
            h = h + (shifted << np.uint32(w))
            w <<= 1
    return h


# Host-path scan tile: large enough to amortize the 5 shifted-add passes,
# small enough that the working set (2 uint32 work buffers per byte) stays
# near L2 instead of streaming 4 B/byte of hashes through main memory.
_NP_TILE = 1 << 20

# Staging slots for the tiled host scan's two uint32 work buffers (hash
# accumulator + shift temporary).  Slots 0/1 are the engine's
# double-buffered device staging; keep these disjoint so a client that
# chunks AND fingerprints on one thread never aliases them.
_NP_WORK_SLOTS = (16, 17)


def _gear_hashes_np_into(buf_slice: np.ndarray, work_h: np.ndarray,
                         work_t: np.ndarray) -> np.ndarray:
    """``gear_hashes_np`` computed in-place inside caller-owned uint32
    work buffers (no per-call temporaries) — the tiled scan's inner loop.
    Returns a view of ``work_h``."""
    m = len(buf_slice)
    h = work_h[:m]
    tmp = work_t[:m]
    with np.errstate(over="ignore"):
        np.copyto(h, buf_slice)          # uint8 widens into the uint32 buffer
        h += np.uint32(1)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
        w = 1
        while w < WINDOW:
            tmp[w:] = h[:-w]
            tmp[:w] = 0
            tmp <<= np.uint32(w)
            h += tmp
            w <<= 1
    return h


def gear_candidates_np(data: bytes | np.ndarray,
                       avg_bits: int = DEFAULT_AVG_BITS) -> np.ndarray:
    """Windowed-hash candidate positions, scanned in cache-sized tiles.

    Equal to ``np.nonzero(candidate_mask(gear_hashes_np(data)))[0]`` but
    never materializes the full 4-bytes-per-input-byte hash array: each
    1 MiB tile is hashed with a 31-byte halo from its predecessor (so
    every emitted position sees a full window) and only the sparse
    candidate indices survive.  The two
    uint32 work buffers come from the thread-local staging pool, so
    repeated calls at any input size reuse ONE fixed allocation
    (asserted by the growth audit in the tests).
    """
    buf = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview))
           else np.asarray(data, dtype=np.uint8))
    n = len(buf)
    mask = np.uint32((1 << avg_bits) - 1)
    if n <= 4096:
        # Tiny inputs: a per-call temporary beats pinning the ~8 MB
        # work pair for a client that only ever chunks small buffers.
        h = gear_hashes_np(buf)
        return np.nonzero((h & mask) == 0)[0]
    span = min(n, _NP_TILE + _HALO)
    work_h = staging_buffer(4 * (_NP_TILE + _HALO),
                            slot=_NP_WORK_SLOTS[0]).view(np.uint32)[:span]
    work_t = staging_buffer(4 * (_NP_TILE + _HALO),
                            slot=_NP_WORK_SLOTS[1]).view(np.uint32)[:span]
    out: list[np.ndarray] = []
    for t in range(0, n, _NP_TILE):
        lo = max(0, t - _HALO)
        h = _gear_hashes_np_into(buf[lo:t + _NP_TILE], work_h, work_t)
        seg = h[t - lo:]
        idx = np.nonzero((seg & mask) == 0)[0]
        if len(idx):
            out.append(idx.astype(np.int64) + t)
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out)


def chunk_stream_np(
    data: bytes,
    min_size: int = DEFAULT_MIN_SIZE,
    avg_bits: int = DEFAULT_AVG_BITS,
    max_size: int = DEFAULT_MAX_SIZE,
    cdc_policy: int = CDC_POLICY_DEFAULT,
) -> list[int]:
    """CPU-vectorized CDC with the exact cut points of ``chunk_stream`` /
    ``chunk_stream_ref`` (same table, window, and selection rule), or of
    ``chunk_stream_skipmin_ref`` under ``cdc_policy=CDC_POLICY_SKIPMIN``."""
    if cdc_policy not in (CDC_POLICY_DEFAULT, CDC_POLICY_SKIPMIN):
        raise ValueError(f"unknown cdc_policy {cdc_policy}")
    n = len(data)
    if n == 0:
        return []
    candidates = gear_candidates_np(data, avg_bits)
    if cdc_policy == CDC_POLICY_SKIPMIN:
        return select_cuts_skipmin(data, candidates, n, min_size, avg_bits,
                                   max_size)
    return select_cuts(candidates, n, min_size, max_size)


def chunk_stream_ref(
    data: bytes,
    min_size: int = DEFAULT_MIN_SIZE,
    avg_bits: int = DEFAULT_AVG_BITS,
    max_size: int = DEFAULT_MAX_SIZE,
) -> list[int]:
    """Canonical serial CDC (hash reset at each chunk start) — the CPU
    referee for cut-point equality tests."""
    if min_size < WINDOW:
        raise ValueError(f"min_size must be >= {WINDOW}")
    mask = np.uint32((1 << avg_bits) - 1)
    table = GEAR_TABLE
    buf = np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    cuts: list[int] = []
    last = 0
    h = np.uint32(0)
    pos = 0
    with np.errstate(over="ignore"):
        while pos < n:
            h = np.uint32(h << np.uint32(1)) + table[buf[pos]]
            size = pos - last + 1
            if (size >= min_size and (h & mask) == 0) or size >= max_size:
                cuts.append(pos + 1)
                last = pos + 1
                h = np.uint32(0)
            pos += 1
    if last < n:
        cuts.append(n)
    return cuts


def chunk_stream_skipmin_ref(
    data: bytes,
    min_size: int = DEFAULT_MIN_SIZE,
    avg_bits: int = DEFAULT_AVG_BITS,
    max_size: int = DEFAULT_MAX_SIZE,
) -> list[int]:
    """Serial referee for the skip-min policy (``cdc_policy=2``).

    After each accepted cut the scanner JUMPS ``min_size - 1`` bytes and
    restarts the hash at the first eligible position — the skipped bytes
    are never hashed (that is the throughput win: ~``min/avg`` of the
    stream is skipped).  A cut lands at the first restart-hash candidate,
    or is forced at ``max_size``.  Boundaries differ from the default
    policy, so this is a distinct content-address namespace.
    """
    if min_size < 1:
        raise ValueError("min_size must be >= 1")
    if max_size < min_size:
        raise ValueError("max_size must be >= min_size")
    mask = np.uint32((1 << avg_bits) - 1)
    table = GEAR_TABLE
    buf = np.frombuffer(data, dtype=np.uint8)
    n = len(buf)
    cuts: list[int] = []
    last = 0
    with np.errstate(over="ignore"):
        while n - last > 0:
            if n - last < min_size:
                cuts.append(n)
                break
            h = np.uint32(0)
            cut = -1
            end = min(last + max_size - 1, n - 1)
            for pos in range(last + min_size - 1, end + 1):
                h = np.uint32(h << np.uint32(1)) + table[buf[pos]]
                if (h & mask) == 0:
                    cut = pos + 1
                    break
            if cut < 0:
                cut = last + max_size if n - last >= max_size else n
            cuts.append(cut)
            if cut >= n:
                break
            last = cut
    return cuts
