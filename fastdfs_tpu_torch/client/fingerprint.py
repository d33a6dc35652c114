"""Client-side chunk fingerprinting for dedup-aware negotiated uploads:
the port of ``fastdfs_tpu/client/fingerprint.py``.

The negotiated upload protocol (UPLOAD_RECIPE / UPLOAD_CHUNKS) moves the
fingerprint work from the storage daemon to the client: it chunks and
hashes the payload, and ships only chunk bytes the daemon's
content-addressed store has never seen.  So the client must produce the
same cut points (the shared gear CDC spec, ``ops.gear_cdc``) and the same
SHA-1 digests as every daemon-side path.

Two routes, chosen by ``device``:

- ``cuda`` (the default): the payload goes to the card once, from this
  thread's pinned staging (kept and grown as the engine's is), with
  ``SEGMENT_SLACK`` zero bytes past its end (``gear_cdc.upload_padded``);
  the device CDC pass cuts it, and one launch of the ragged SHA-1 kernel
  (``ops.cuda_sha1.sha1_ragged_cuda``) hashes every chunk where it lies
  in that same buffer; the digests come back in one copy.  A failure to
  build or launch raises.
- ``cpu``: the reference's route on a host without an accelerator, the
  NumPy chunker (``chunk_stream_np``) plus ``hashlib``.

A wrong fingerprint cannot corrupt the store: the daemon re-verifies
SHA1(payload) == digest before it admits any byte.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from fastdfs_tpu_torch.ops import (SEGMENT_SLACK, chunk_table, gear_cdc,
                                   pack_chunk_table, resolve_device)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_ragged_cuda
from fastdfs_tpu_torch.ops.sha1 import digest_bytes


@dataclass(frozen=True)
class ChunkFingerprint:
    length: int
    digest: bytes  # 20-byte raw SHA1


def _digests_device(seg: torch.Tensor, cuts: list[int]) -> list[bytes]:
    """Raw SHA-1 digests of the chunks that ``cuts`` (exclusive ends, the
    first chunk starting at 0) mark in ``seg``: one ``sha1_ragged_cuda``
    launch on ``seg``'s device and one copy back.

    ``seg`` is a uint8 tensor holding at least ``SEGMENT_SLACK`` bytes past
    the last cut, as ``upload_padded`` stages it.  The chunk table
    (``ops.pack_chunk_table``) goes up in one copy.  On the CPU the launch
    is the kernel's plain twin.
    """
    ends = np.asarray(cuts, dtype=np.int64)
    n = len(ends)
    if not n:
        return []
    lens = np.diff(ends, prepend=0)
    if ((lens < 0).any() or lens.max() >= 1 << 31
            or seg.shape[0] < ends[-1] + SEGMENT_SLACK):
        raise ValueError("cuts must increase, leave chunks under 2 GiB and "
                         f"end {SEGMENT_SLACK} bytes before the buffer does")
    table = np.empty(2 * n, dtype=np.int64)
    pack_chunk_table(table, ends - lens, lens)
    tab = torch.from_numpy(table).to(seg.device)
    raw = digest_bytes(sha1_ragged_cuda(seg, *chunk_table(tab, n)))
    return [raw[i * 20:(i + 1) * 20] for i in range(n)]


def _fingerprint_device(data: bytes, min_size: int, avg_bits: int,
                        max_size: int, cdc_policy: int, device: torch.device
                        ) -> tuple[list[int], list[bytes]]:
    """The card's route: one upload shared by the CDC pass and the SHA-1
    launch.  Returns the cuts and the chunks' raw digests."""
    host, seg = gear_cdc.upload_padded(data, device, slack=SEGMENT_SLACK)
    cuts = gear_cdc.device_cuts(host, seg, len(data), min_size, avg_bits,
                                max_size, cdc_policy)
    return cuts, _digests_device(seg, cuts)


def fingerprint_buffer(
    data: bytes,
    min_size: int = gear_cdc.DEFAULT_MIN_SIZE,
    avg_bits: int = gear_cdc.DEFAULT_AVG_BITS,
    max_size: int = gear_cdc.DEFAULT_MAX_SIZE,
    cdc_policy: int = gear_cdc.CDC_POLICY_DEFAULT,
    device: str | torch.device = "cuda",
) -> list[ChunkFingerprint]:
    """CDC-chunk ``data`` and SHA1 each chunk, exactly as the daemons do.

    Returns one :class:`ChunkFingerprint` per chunk, in stream order
    (lengths sum to ``len(data)``).  Empty input -> empty list.

    ``cdc_policy`` must match the target group's policy (the default is
    the frozen ref-identical rule); a client chunking under a different
    policy than the daemon simply gets zero dedup hits.  ``device`` is
    ``cuda`` unless the caller passes ``cpu``; asking for CUDA where there
    is none raises.
    """
    dev = resolve_device(device)
    if not data:
        return []
    if dev.type == "cpu":
        cuts = gear_cdc.chunk_stream_np(data, min_size, avg_bits, max_size,
                                        cdc_policy=cdc_policy)
        digests = [hashlib.sha1(data[a:b]).digest()
                   for a, b in zip([0] + cuts[:-1], cuts)]
    else:
        cuts, digests = _fingerprint_device(data, min_size, avg_bits,
                                            max_size, cdc_policy, dev)
    return [ChunkFingerprint(length=b - a, digest=dig)
            for a, b, dig in zip([0] + cuts[:-1], cuts, digests)]
