"""SHA-1 of ragged chunks: the CUDA kernel ``csrc/sha1.cu`` and its wrappers.

Replaces ``fastdfs_tpu/ops/pallas_sha1.py:sha1_batch_pallas`` (the Pallas
kernel ``_sha1_kernel``, called at pallas_sha1.py:93).  One launch hashes
every chunk of a segment where it lies (``sha1_ragged_cuda``): one thread
per chunk, longest chunks first when the caller passes an ``order``,
unaligned starts rebuilt from aligned loads, padding done in the kernel.
``sha1_batch_cuda`` is the padded ``(N, L)`` entry, a thin adapter over
the same kernel with ``offsets = i * L``.

Bound on an H100: the longest chunk's serial chain of 80-round blocks
(PERF.md gives the measured time beside it).

On a CPU tensor a wrapper returns its plain twin (``ops.sha1.sha1_ragged``
or ``sha1_batch``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from fastdfs_tpu_torch.ops import (_build, check_batch, check_out,
                                   check_ragged)
from fastdfs_tpu_torch.ops.sha1 import sha1_batch, sha1_ragged


def _launch(seg, offsets, lens, order, out) -> None:
    n = offsets.shape[0]
    if not n:
        return
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        rc = _build.library().fdfs_sha1_ragged(
            seg.data_ptr(), offsets.data_ptr(), lens.data_ptr(),
            None if order is None else order.data_ptr(), n, out.data_ptr(),
            out.stride(0), stream)
    _build.check_launch(rc, "sha1_ragged")


def sha1_ragged_cuda(seg: torch.Tensor, offsets: torch.Tensor,
                     lens: torch.Tensor, order: torch.Tensor | None = None,
                     out: torch.Tensor | None = None, row_tile: int = 256
                     ) -> torch.Tensor:
    """uint8 ``(S,)`` segment + int64 offsets, int32 lengths and an
    optional int32 order ``(N,)`` -> uint32 ``(N, 5)`` digests.

    ``order`` lists the chunks longest first (any permutation is
    correct).  ``out``, if given, is an int32 ``(N, 5)`` view with unit
    column stride (columns of a wider result); it is returned as uint32.
    ``row_tile`` only sizes the plain twin's tiles on the CPU.
    """
    check_ragged(seg, offsets, lens, order)
    n = offsets.shape[0]
    if out is None:
        out = torch.empty((n, 5), dtype=torch.int32, device=seg.device)
    check_out(out, n, 5, seg.device)
    if seg.device.type == "cpu":
        out.copy_(sha1_ragged(seg, offsets, lens, row_tile).view(torch.int32))
    elif n:
        _launch(seg, offsets, lens, order, out)
        sha1_ragged_cuda.launches += 1
    return out.view(torch.uint32)


sha1_ragged_cuda.launches = 0


def sha1_batch_cuda(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 ``(N, L)`` + int32 ``(N,)`` -> uint32 ``(N, 5)`` digests.

    Lengths are clamped to [0, L], so the kernel never reads past a row.
    """
    check_batch(data, lengths)
    if data.device.type == "cpu":
        return sha1_batch(data, lengths)
    n, pitch = data.shape
    out = torch.empty((n, 5), dtype=torch.int32, device=data.device)
    if n:
        offsets = torch.arange(n, dtype=torch.int64, device=data.device) * pitch
        _launch(data.reshape(-1), offsets, lengths.clamp(0, pitch), None, out)
        sha1_batch_cuda.launches += 1
    return out.view(torch.uint32)


sha1_batch_cuda.launches = 0
