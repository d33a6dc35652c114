"""The storage daemon's content-defined cuts, frozen for the benchmark.

The rule of ``fastdfs_tpu_torch/ops/gear_cdc.py``'s host chunker
(``chunk_stream_np`` under the default policy: the fmix32 gear table,
the 32-byte window, ``select_cuts``), kept here so that a later change
to the program cannot move the cuts the benchmark hands it.  The
daemon's native chunker shares the table, window and selection rule, so
these are the cuts a ``DEDUP_FINGERPRINT_CUTS`` request carries.

The candidate scan, a NumPy pass in the original, is written in plain
torch so that set-up runs it on the card (a few milliseconds a segment
against half a second on the host); the tests hold its cuts to
``chunk_stream_np``'s.  Greedy selection stays on the host, as in the
original.
"""

from __future__ import annotations

import numpy as np

WINDOW = 32
_HALO = WINDOW - 1
_TILE = 1 << 23


def _fmix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


GEAR_TABLE = _fmix32(np.arange(1, 257, dtype=np.uint32))


def gear_candidates(data: bytes, avg_bits: int, device) -> np.ndarray:
    """Positions whose windowed gear hash has its low ``avg_bits`` bits
    zero, worked out with torch on ``device`` in tiles with a 31-byte
    halo: the table value fmix32(byte + 1), then five prefix-doubling
    shifted adds, h[i] = sum over the 32-byte window of gear << distance
    (mod 2**32), in int64 masked to 32 bits."""
    import torch

    buf = torch.frombuffer(bytearray(data) if isinstance(data, bytes)
                           else data, dtype=torch.uint8)
    n = len(buf)
    table = torch.as_tensor(GEAR_TABLE.astype(np.int64), device=device)
    mask = (1 << avg_bits) - 1
    out = []
    for t in range(0, n, _TILE):
        lo = max(0, t - _HALO)
        h = table[buf[lo:t + _TILE].to(device).long()]
        w = 1
        while w < WINDOW:
            shifted = torch.zeros_like(h)
            shifted[w:] = h[:-w]
            h = (h + (shifted << w)) & 0xFFFFFFFF
            w <<= 1
        idx = torch.nonzero((h[t - lo:] & mask) == 0).flatten()
        if len(idx):
            out.append(idx.cpu().numpy() + t)
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def select_cuts(candidates: np.ndarray, n: int, min_size: int,
                max_size: int) -> list[int]:
    """Greedy cut selection: each chunk ends after the first candidate at
    least ``min_size`` bytes in, or at ``max_size``; the last ends at
    ``n``.  Returns the exclusive chunk ends."""
    if min_size < WINDOW:
        raise ValueError(f"min_size must be >= {WINDOW}")
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


def chunk_cuts(data: bytes, min_size: int, avg_bits: int, max_size: int,
               device="cpu") -> list[int]:
    """The exclusive chunk ends of ``data`` (``chunk_stream_np``'s)."""
    if not len(data):
        return []
    return select_cuts(gear_candidates(data, avg_bits, device), len(data),
                       min_size, max_size)
