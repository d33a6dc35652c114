"""Fingerprint ops of the port: SHA-1, the MinHash survivor sketch, gear CDC.

Each kernel module pairs a hand-written CUDA kernel (``cuda_sha1``,
``cuda_minhash``) with its plain PyTorch twin (``sha1``, ``minhash``).
The kernels take a segment as it arrived plus a table of chunk offsets
and lengths ("ragged"); the twins gather the same chunks into
zero-padded fixed-shape tiles (``ragged_batches``).

32-bit words: torch's ``uint32`` has no shifts, adds or minimum, so the
plain twins compute in int64 holding values in ``[0, 2**32)``, masked
after every operation that could leave that range.  Public functions
take and return ``uint32`` tensors; ``widen`` and ``narrow`` convert at
that boundary.  Multiplications whose product could pass 2**63 go
through ``mul32``, which splits one factor into 16-bit halves.

The package re-exports the reference's op names (``fastdfs_tpu/ops``):
``sha1_batch``, ``sha1_hex``, ``chunk_stream``, ``chunk_stream_ref``,
``gear_hashes``, ``gear_hashes_ref``, ``select_cuts``, ``GEAR_TABLE``,
``shingle_hashes``, ``survivor_segmin``, ``minhash_signature``,
``minhash_batch`` and ``estimate_jaccard``.  They take and return torch
tensors where the reference takes JAX arrays, and the plain twins run on
the device their inputs lie on.  One signature differs: ``chunk_stream``
takes ``device`` (``"cuda"`` unless the caller passes ``"cpu"``), where
its device CDC pass runs.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# Zero bytes kept past a segment's end in its staging buffer, so that no
# kernel load near the last chunk leaves the allocation.
SEGMENT_SLACK = 64


def resolve_device(device: str | torch.device) -> torch.device:
    """An entry point's device; asking for CUDA where there is none
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def widen(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit pattern) tensor -> int64 in [0, 2**32)."""
    if x.dtype == torch.int64:
        return x & MASK32
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> uint32 tensor with the same bits."""
    return x.to(torch.int32).view(torch.uint32)


def mean_of_count(count: torch.Tensor, p: int) -> torch.Tensor:
    """The reference's float32 mean of ``count`` ones among ``p`` values:
    XLA multiplies the float32 sum by the float32 reciprocal of ``p``, so
    ``count * fl32(1 / p)``, which differs from a true division ``count /
    p`` in the last bit for some counts where ``p`` is not a power of
    two."""
    return count.to(torch.float32) * float(np.float32(1) / np.float32(p))


def split16(c):
    """``c`` in [0, 2**32) (a Python int or an int64 tensor) -> its low and
    high 16-bit halves, the form ``mul32`` multiplies by."""
    return c & 0xFFFF, c >> 16


def mul32(x: torch.Tensor, c, add: torch.Tensor | None = None
          ) -> torch.Tensor:
    """``(x * c + add) mod 2**32`` for int64 ``x``, ``add`` and ``c`` in
    [0, 2**32) without int64 overflow.  ``c`` is a Python int, a
    broadcastable tensor, or its ``split16`` halves (hoisted out of a loop
    that multiplies by the same ``c``)."""
    lo, hi = c if isinstance(c, tuple) else split16(c)
    prod = x * lo + (((x * hi) & 0xFFFF) << 16)
    if add is not None:
        prod = prod + add
    return prod & MASK32


def check_batch(data: torch.Tensor, lengths: torch.Tensor) -> None:
    """A kernel wrapper's input contract: uint8 (N, L) rows and int32 (N,)
    lengths on one device."""
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(f"data must be uint8 (N, L), got {data.dtype} "
                         f"{tuple(data.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (data.shape[0],):
        raise ValueError(f"lengths must be int32 ({data.shape[0]},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError(f"data on {data.device}, lengths on {lengths.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if data.device.type == "cuda" and not (data.is_contiguous()
                                           and lengths.is_contiguous()):
        raise ValueError("data and lengths must be contiguous")


def check_ragged(seg: torch.Tensor, offsets: torch.Tensor,
                 lens: torch.Tensor, order: torch.Tensor | None = None
                 ) -> None:
    """A ragged kernel wrapper's input contract: a uint8 (S,) segment,
    int64 (N,) offsets, int32 (N,) lengths and an optional int32 (N,)
    order, contiguous, on one device.  Chunk i is
    ``seg[offsets[i]:offsets[i] + lens[i]]``; the caller keeps every
    chunk inside ``seg`` (the kernels do not read device values back to
    check)."""
    if seg.dtype != torch.uint8 or seg.ndim != 1:
        raise ValueError(f"seg must be uint8 (S,), got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    n = offsets.shape[0] if offsets.ndim == 1 else -1
    for name, t, dtype in (("offsets", offsets, torch.int64),
                           ("lens", lens, torch.int32),
                           ("order", order, torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype or t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be {dtype} (N,) like offsets, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != seg.device:
            raise ValueError(f"seg on {seg.device}, {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seg.device}")
    if not seg.is_contiguous():
        raise ValueError("seg must be contiguous")


def pack_chunk_table(table: np.ndarray, offsets: np.ndarray,
                     lens: np.ndarray) -> None:
    """Lay a ragged chunk table into the first ``2 N`` entries of an int64
    array, so that it goes to the card in one copy: the ``N`` offsets,
    then the int32 lengths and the int32 longest-first order (a warp's
    SHA-1 lanes then run similar chains).  ``chunk_table`` reads it."""
    n = len(lens)
    table[:n] = offsets
    pairs = table[n:2 * n].view(np.int32)
    pairs[:n] = lens
    pairs[n:] = np.argsort(-lens, kind="stable")


def chunk_table(tab: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int64 offsets, int32 lengths and int32 order of an ``n``-chunk
    table that ``pack_chunk_table`` laid out, as views of ``tab``."""
    pairs = tab[n:2 * n].view(torch.int32)
    return tab[:n], pairs[:n], pairs[n:]


def check_out(out: torch.Tensor, n: int, width: int,
              device: torch.device) -> None:
    """An output a ragged kernel writes: int32 (n, width) rows with unit
    column stride (a column slice of a wider array is fine)."""
    if (out.dtype != torch.int32 or out.shape != (n, width)
            or (n and width > 1 and out.stride(1) != 1)
            or out.device != device):
        raise ValueError(f"out must be int32 ({n}, {width}) with unit "
                         f"column stride on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} strides {out.stride()} on "
                         f"{out.device}")


def bucket_lens(lens: np.ndarray, min_size: int, max_size: int
                ) -> np.ndarray:
    """The reference engine's bucket rule, vectorized: the smallest
    power-of-two multiple of ``max(min_size, 1)`` that holds each length,
    clamped to ``max_size``; a length past ``max_size`` is its own
    bucket."""
    lens = np.asarray(lens, dtype=np.int64)
    b = np.full(lens.shape, max(min_size, 1), dtype=np.int64)
    while True:
        short = b < lens
        if not short.any():
            break
        b = np.where(short, b << 1, b)
    return np.where(lens <= max_size, np.minimum(b, max_size), lens)


# The plain twins' tile widths: powers of two from 64 bytes (the smallest
# CDC chunk the tests configure) to 64 KiB (the default max_size).
_MIN_BUCKET = 64
_MAX_BUCKET = 1 << 16


def ragged_batches(seg: torch.Tensor, offsets: torch.Tensor,
                   lens: torch.Tensor, row_tile: int):
    """Gather ragged chunks into zero-padded ``(<= row_tile, bucket)``
    batches, one bucket length per group (``bucket_lens`` from 64 bytes
    to 64 KiB), on the segment's device: the fixed-shape tiles the plain
    twins take.  Yields
    ``(rows, batch, batch_lens)``: the chunk indices (an int64 tensor),
    uint8 rows zero past each length, and their int32 lengths.  One
    vectorized gather per tile, no loop over chunks."""
    dev = seg.device
    lens_h = lens.cpu().numpy().astype(np.int64)
    buckets = bucket_lens(lens_h, _MIN_BUCKET, _MAX_BUCKET)
    last = max(seg.shape[0] - 1, 0)
    for blen in np.unique(buckets):
        idx = np.nonzero(buckets == blen)[0]
        for start in range(0, len(idx), row_tile):
            rows = torch.as_tensor(idx[start:start + row_tile], device=dev)
            ln = lens[rows]
            col = torch.arange(int(blen), device=dev)
            pos = (offsets[rows][:, None] + col).clamp(max=last)
            inside = col < ln[:, None].to(torch.int64)
            batch = (torch.where(inside, seg[pos], 0).to(torch.uint8)
                     if seg.shape[0] else
                     torch.zeros(inside.shape, dtype=torch.uint8, device=dev))
            yield rows, batch, ln


# The reference's re-exports.  They come after the helpers above: every
# submodule imports those from this module while it is still loading.
from fastdfs_tpu_torch.ops.gear_cdc import (  # noqa: E402,F401
    GEAR_TABLE,
    gear_hashes,
    gear_hashes_ref,
    select_cuts,
    chunk_stream,
    chunk_stream_ref,
)
from fastdfs_tpu_torch.ops.sha1 import sha1_batch, sha1_hex  # noqa: E402,F401
from fastdfs_tpu_torch.ops.minhash import (  # noqa: E402,F401
    shingle_hashes,
    survivor_segmin,
    minhash_signature,
    minhash_batch,
    estimate_jaccard,
)
