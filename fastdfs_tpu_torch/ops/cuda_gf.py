"""The GF(2^8) product of Reed-Solomon on the card: ``csrc/gf_matmul.cu``.

Replaces device code that the reference leaves to XLA, not a Pallas
kernel: ``fastdfs_tpu/ops/rs_code.py:_gf_matmul_jit`` (rs_code.py:170-178,
driven by ``gf_matmul`` at :187-206), the product-table gather of a
``(rows, k)`` matrix over ``k`` shards, XOR-reduced over ``k``.

``gf_matmul_cuda(matrix, shards, out=None)``: one launch per call.  Each
coefficient's products come from three tables of 8, 8 and 4 bytes (the
shard byte's 3-, 3- and 2-bit fields), built from the product table in
shared memory and looked up four bytes at a time in registers by
``__byte_perm``; a thread owns 16 columns of up to 32 rows and walks the
shards with one coalesced 16-byte load a step.  Bound on an H100:
``rows * k * L`` products, against ``(k + rows) * L`` bytes
(``chip_smoke.py`` computes both; PERF.md has the measured time).  On a CPU tensor it returns the
plain twin, ``ops.rs_code.gf_matmul_torch``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fastdfs_tpu_torch.ops import _build, rs_code


@functools.lru_cache(maxsize=None)
def _table(dev: torch.device) -> torch.Tensor:
    """The product table on ``dev``, copied there once."""
    return torch.from_numpy(np.ascontiguousarray(rs_code.PROD_TABLE)).to(dev)


def gf_matmul_cuda(matrix, shards: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """``out[r, l] = XOR_i PROD[matrix[r, i], shards[i, l]]``: a uint8
    ``(rows, k)`` matrix (NumPy or a tensor) and uint8 ``(k, L)`` shards
    -> uint8 ``(rows, L)`` on the shards' device, bit-identical to
    ``rs_code.gf_matmul_np``.  ``rows`` and ``k`` are at most
    ``MAX_SHARDS``.  ``shards`` and ``out`` (written when given) need unit
    column stride, not contiguous rows, so views such as ``d[m:]`` pass
    without a copy."""
    mat = (matrix if isinstance(matrix, torch.Tensor)
           else torch.from_numpy(np.ascontiguousarray(matrix)))
    if mat.dtype != torch.uint8 or mat.ndim != 2:
        raise ValueError(f"matrix must be uint8 (rows, k), got {mat.dtype} "
                         f"{tuple(mat.shape)}")
    rows, k = mat.shape
    if max(rows, k) > rs_code.MAX_SHARDS:
        raise ValueError(f"rows and k must be at most {rs_code.MAX_SHARDS}, "
                         f"got {tuple(mat.shape)}")
    if shards.dtype != torch.uint8 or shards.ndim != 2 \
            or shards.shape[0] != k:
        raise ValueError(f"shards must be uint8 ({k}, L), got {shards.dtype} "
                         f"{tuple(shards.shape)}")
    dev = shards.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    length = shards.shape[1]
    if out is None:
        out = torch.empty((rows, length), dtype=torch.uint8, device=dev)
    elif (out.dtype != torch.uint8 or out.shape != (rows, length)
          or out.device != dev):
        raise ValueError(f"out must be uint8 ({rows}, {length}) on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    for name, t in (("shards", shards), ("out", out)):
        if length > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit column stride, got "
                             f"strides {t.stride()}")
    if dev.type == "cpu":
        return out.copy_(rs_code.gf_matmul_torch(mat.numpy(), shards))
    if not (rows and k):
        return out.zero_()
    if length:
        d_mat = mat.to(dev, non_blocking=True).contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _build.library().fdfs_gf_matmul(
                _table(dev).data_ptr(), d_mat.data_ptr(), rows, k,
                shards.data_ptr(), shards.stride(0), length, out.data_ptr(),
                out.stride(0), stream)
        _build.check_launch(rc, "gf_matmul")
        gf_matmul_cuda.launches += 1
    return out


gf_matmul_cuda.launches = 0
