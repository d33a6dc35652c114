"""Gear CDC on the card: the CUDA kernel ``csrc/gear_cdc.cu`` and its wrappers.

Replaces device code that the reference leaves to XLA, not a Pallas
kernel: ``fastdfs_tpu/ops/gear_cdc.py:gear_candidates`` (jitted at
gear_cdc.py:225, over ``gear_hashes`` at :189) and the ingest step's
stage-1 CDC (``fastdfs_tpu/parallel/ingest_step.py:92-105``).

- ``gear_candidates_cuda``: the first ``k`` candidate positions below
  ``n``, sorted and padded with the buffer's length, then their total
  count, in one buffer that the caller fetches with one copy; the path
  of ``gear_cdc.device_cuts`` (the client's fingerprint and
  ``DEDUP_FINGERPRINT``).
- ``block_candidates_cuda``: the dense candidate mask of byte rows, each
  after the gear values of the 31 bytes before it; the ingest step's
  stage 1 and the entry's candidates.

Both forms run on a persistent grid (the card's SMs times the blocks
that fit on one, from the occupancy API), each block with the gear table
in shared memory, one copy per bank, filled once; a block stages its
next 32 KiB tile by ``cp.async`` while it hashes this one, a thread per
128 positions in 32-bit registers, one table read and one hash a
position.  The compacted form is one pass: a block takes a span of
consecutive tiles, keeps the candidate bits of its thread runs in the
scratch, finds the span's offset by a decoupled look-back over the spans
before it and writes the span's candidates at their ranks.  The dense
form stores its mask 16 bytes at a time.  The compacted form's scratch,
allocated on each call beside the buffer, is about ``n / 8`` bytes:
room for each thread run's 128 candidate bits (4 KiB a tile) and the
look-back's status words.  Bound on an H100: the bytes, one read of the
buffer (PERF.md gives the kernel's time beside it).  On a CPU tensor a
wrapper returns its plain twin (``gear_cdc.gear_candidates``,
``gear_cdc.block_candidates``); on a CUDA tensor it launches the kernel
or raises.

``ops.gear_cdc`` imports this module while it loads (the package loads
``gear_cdc`` first), so the plain twins are read from the module object
at call time.
"""

from __future__ import annotations

import torch

from fastdfs_tpu_torch.ops import _build, gear_cdc

HALO = 31                 # gear_cdc.WINDOW - 1 (csrc/gear_cdc.cu, kHalo)
RUN = 128                 # positions per thread (csrc/gear_cdc.cu, kRun)
TILE = 256 * RUN          # positions per tile (csrc/gear_cdc.cu, kTile)


def _check_bits(avg_bits: int) -> None:
    if not 0 <= avg_bits <= 32:
        raise ValueError(f"avg_bits must be in [0, 32], got {avg_bits}")


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device} for {name}")


def gear_candidates_cuda(buf: torch.Tensor, n: int, avg_bits: int, k: int
                         ) -> torch.Tensor:
    """uint8 ``(S,)`` buffer -> int64 ``(k + 1,)`` on its device: the
    first ``k`` candidate positions below ``n``, sorted and padded with
    ``S``, then the number of candidates below ``n`` (more than ``k``
    where the positions were cut short).  Bit-identical to
    ``gear_cdc.gear_candidates``."""
    _check_bits(avg_bits)
    if buf.dtype != torch.uint8 or buf.ndim != 1:
        raise ValueError(f"buf must be uint8 (S,), got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    size = buf.shape[0]
    if not 0 <= n <= size:
        raise ValueError(f"n must be in [0, {size}], got {n}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    _check_device(buf, "buf")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous")
    if buf.device.type == "cpu":
        return gear_cdc.gear_candidates(buf, n, avg_bits, k)
    out = torch.empty(k + 1, dtype=torch.int64, device=buf.device)
    if n == 0:
        out[:k] = size
        out[k] = 0
        return out
    tiles = -(-n // TILE)
    if tiles >= 1 << 31:
        raise ValueError(f"n = {n} is past the kernel's {TILE << 31} bytes")
    # A span counter and status words, then a map of each tile's thread
    # runs with candidates and those runs' bits (csrc/gear_cdc.cu): about
    # n / 8 bytes.
    scratch = torch.empty(((tiles + 2) & ~1) + tiles * (4 + TILE // 64),
                          dtype=torch.int64, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = _build.library().fdfs_gear_candidates(
            buf.data_ptr(), size, n, avg_bits, k, out.data_ptr(),
            scratch.data_ptr(), stream)
    _build.check_launch(rc, "gear_candidates")
    gear_candidates_cuda.launches += 1
    return out


gear_candidates_cuda.launches = 0


def block_candidates_cuda(rows: torch.Tensor, halo: torch.Tensor,
                          avg_bits: int) -> torch.Tensor:
    """uint8 ``(B, L)`` rows (any row stride, unit stride within a row)
    and int64 ``(B, 31)`` gear values of the bytes before each row ->
    bool ``(B, L)``: the candidates of the rows as parts of their
    streams, bit-identical to
    ``gear_cdc.block_candidates(gear_values(rows), halo, avg_bits)``.
    A row that starts its stream takes a halo of zeros."""
    _check_bits(avg_bits)
    if rows.dtype != torch.uint8 or rows.ndim != 2:
        raise ValueError(f"rows must be uint8 (B, L), got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    b, length = rows.shape
    if halo.dtype != torch.int64 or halo.shape != (b, HALO):
        raise ValueError(f"halo must be int64 ({b}, {HALO}), got "
                         f"{halo.dtype} {tuple(halo.shape)}")
    if halo.device != rows.device:
        raise ValueError(f"rows on {rows.device}, halo on {halo.device}")
    _check_device(rows, "rows")
    if (length > 1 and rows.stride(1) != 1) or not halo.is_contiguous():
        raise ValueError("rows need unit stride within a row and halo must "
                         "be contiguous")
    if rows.device.type == "cpu":
        return gear_cdc.block_candidates(gear_cdc.gear_values(rows), halo,
                                         avg_bits)
    if b >= 1 << 16:
        raise ValueError(f"{b} rows, the kernel takes at most 65535")
    out = torch.empty((b, length), dtype=torch.bool, device=rows.device)
    if b and length:
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            rc = _build.library().fdfs_gear_block_mask(
                rows.data_ptr(), rows.stride(0), b, length, halo.data_ptr(),
                avg_bits, out.data_ptr(), stream)
        _build.check_launch(rc, "gear_block_mask")
        block_candidates_cuda.launches += 1
    return out


block_candidates_cuda.launches = 0
