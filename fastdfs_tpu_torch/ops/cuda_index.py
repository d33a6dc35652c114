"""The ingest step's index query on the card: ``csrc/index_query.cu``.

Replaces device code that the reference leaves to XLA, not a Pallas
kernel: the index query of the jitted step,
``fastdfs_tpu/parallel/ingest_step.py:128-133`` (``eq.mean(axis=2,
dtype=float32)`` over the ``(N, M, P)`` comparison, then the max over
the shard's rows with ``initial=0.0``).

``index_best_cuda(sigs, index)``: for each query signature, the largest
fraction of equal lanes over the index rows, as float32.  A block keeps
64 queries and streams 64-row tiles of its slice of the index through
shared memory; slices meet in an int32 ``atomicMax``.  Bound on an H100:
two integer instructions per (query, row, lane) over the INT32 rate
(PERF.md gives the measured time beside it).  On a CPU tensor it
returns its plain twin, ``index_best`` (re-exported by
``parallel.ingest_step``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from fastdfs_tpu_torch.ops import _build, mean_of_count

_INT_LIMIT = (1 << 31) - 64

# (query, index row) pairs the plain twin scores at once: a bool
# (pairs, P) comparison, 256 MB at P = 64, where the reference
# materialises all N x M_loc x P at once.
QUERY_PAIRS = 1 << 22


def index_best(sigs: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Best similarity of each query against an index shard: int32 bits
    ``sigs`` (N, P) and ``index`` (M, P) -> float32 (N,), the largest
    fraction of equal lanes, 0.0 for an empty shard.  Scored in tiles of
    ``QUERY_PAIRS`` pairs; ``k * fl32(1 / P)`` (``ops.mean_of_count``)
    is the same float32 as the reference's mean of ``k`` ones.

    The plain twin of ``csrc/index_query.cu`` (``index_best_cuda``);
    ``index_best.cuda_calls`` counts its calls on a CUDA tensor, which
    the card's paths leave to the kernel."""
    if sigs.device.type == "cuda":
        index_best.cuda_calls += 1
    n, p = sigs.shape
    m = index.shape[0]
    best = torch.zeros(n, dtype=torch.int64, device=sigs.device)
    if m:
        tm = min(m, QUERY_PAIRS)
        tn = max(1, QUERY_PAIRS // tm)
        for n0 in range(0, n, tn):
            q = sigs[n0:n0 + tn, None, :]
            for m0 in range(0, m, tm):
                eq = q == index[None, m0:m0 + tm, :]
                best[n0:n0 + tn] = torch.maximum(best[n0:n0 + tn],
                                                 eq.sum(dim=2).amax(dim=1))
    return mean_of_count(best, p)


index_best.cuda_calls = 0


def index_best_cuda(sigs: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int32 bits of uint32 signatures ``sigs`` (N, P) and ``index``
    (M, P) -> float32 (N,): the largest count of equal lanes over the
    rows, over ``P``; 0.0 where ``M`` is 0.  Bit-identical to
    ``index_best``."""
    for name, t in (("sigs", sigs), ("index", index)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be int32 (rows, P), got {t.dtype} "
                             f"{tuple(t.shape)}")
    n, p = sigs.shape
    m = index.shape[0]
    if index.shape[1] != p or p < 1:
        raise ValueError(f"sigs and index must share P >= 1 lanes, got "
                         f"{tuple(sigs.shape)} and {tuple(index.shape)}")
    if index.device != sigs.device:
        raise ValueError(f"sigs on {sigs.device}, index on {index.device}")
    if sigs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sigs.device}")
    if not (sigs.is_contiguous() and index.is_contiguous()):
        raise ValueError("sigs and index must be contiguous")
    if sigs.device.type == "cpu":
        return index_best(sigs, index)
    if max(n, m, p) >= _INT_LIMIT:
        raise ValueError(f"shapes {tuple(sigs.shape)}, {tuple(index.shape)} "
                         f"are past the kernel's 32-bit counts")
    best = torch.zeros(n, dtype=torch.float32, device=sigs.device)
    if n and m:
        sms = torch.cuda.get_device_properties(
            sigs.device).multi_processor_count
        with torch.cuda.device(sigs.device):
            stream = torch.cuda.current_stream(sigs.device).cuda_stream
            rc = _build.library().fdfs_index_best(
                sigs.data_ptr(), index.data_ptr(), n, m, p, sms,
                best.data_ptr(), stream)
        _build.check_launch(rc, "index_best")
        index_best_cuda.launches += 1
    return best


index_best_cuda.launches = 0
