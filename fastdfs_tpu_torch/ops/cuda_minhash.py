"""MinHash sketch of ragged chunks: the kernels of ``csrc/minhash_survivor.cu``.

Replaces ``fastdfs_tpu/ops/pallas_minhash.py:survivor_segmin_pallas``
(the Pallas kernel ``_survivor_kernel``, called at pallas_minhash.py:121)
together with the stage 4 that the reference runs after it in XLA: one
block per chunk computes the shingle hashes, the value-keyed survivors,
the segment minima and the 64 permutation minima, reading each byte once
and writing only the ``(N, 64)`` signatures (and ``z`` when asked for).
The file holds two such kernels: ``sketch_ragged_kernel`` at shingle
width 5 (the Pallas kernel's width) and ``sketch_k_kernel`` at any other
width ``k >= 1``, where the reference runs its XLA ``survivor_segmin``
(``fastdfs_tpu/ops/minhash.py:98``) and then its XLA stage 4; the
wrappers take ``k`` and choose.

- ``sketch_ragged_cuda``: one launch over every chunk of a segment where
  it lies, stage 4 fused, at any ``k``; the engine's path at 64
  permutations.
- ``survivor_ragged_cuda``: stages 1-3 (``z``) at any ``k``: at k = 5 the
  k = 5 kernel read back through its ``z`` output, at any other ``k`` the
  general kernel's ``z`` form (no stage 4); the engine's path at another
  permutation count.
- ``minhash_batch_cuda`` and ``survivor_segmin_cuda``: the padded
  ``(N, L)`` entries, thin adapters over the same kernels with
  ``offsets = i * L``.
- ``signature_tiles_cuda``: stage 4 alone, over survivor vectors ``z``
  and the permutation words of any count or of a tensor-parallel rank's
  slice, on the kernel ``csrc/minhash_sig.cu`` (a warp a row on
  persistent blocks, the survivors compacted into the warp's slice of
  shared memory).  It replaces the reference's
  XLA stage 4 (``fastdfs_tpu/ops/minhash.py:minhash_signature``, and the
  ingest step's ``vmap(one_sig)``) wherever the fused kernels' 64
  permutations do not apply: the ingest step's ``tp > 1`` ranks and the
  engine and the steps at another count.  Bound: 4 KiB read a row,
  against two instructions per survivor and permutation.

The fused kernels sign with 64 permutations.  Bound on an H100: about 6
integer instructions per byte position, at any ``k``, against one byte
read, so operations and HBM bytes bound them about equally (PERF.md
gives the measured times beside it).  On a CPU tensor a wrapper returns
its plain twin (``ops.minhash.sketch_ragged``, ``minhash_batch``,
``survivor_ragged``, ``survivor_segmin``, ``signature_tiles``); on a
CUDA tensor it launches a kernel or raises.
"""

from __future__ import annotations

import torch

from fastdfs_tpu_torch.ops import _build, check_batch, check_out, check_ragged
from fastdfs_tpu_torch.ops.minhash import (_POLY_B, DEFAULT_PERMS,
                                           DEFAULT_SHINGLE, NUM_SEGMENTS,
                                           minhash_batch, perm_words,
                                           perms_from_words, signature_tiles,
                                           sketch_ragged, survivor_ragged,
                                           survivor_segmin)

KERNEL_PERMS = 64
KERNEL_SHINGLE = 5   # sketch_ragged_kernel's; sketch_k_kernel takes the rest


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"shingle width k must be at least 1, got {k}")


def _launch(seg, offsets, lens, order, words, sig, z, k: int) -> None:
    """One launch over every chunk: the k = 5 kernel at k = 5, the general
    kernel at any other ``k``.  ``sig`` (with ``words``) and ``z`` are
    int32 outputs; the general kernel takes either alone."""
    n = offsets.shape[0]
    if not n:
        return
    if words is not None and (
            words.dtype != torch.int32 or words.shape != (2, KERNEL_PERMS)
            or words.device != seg.device or not words.is_contiguous()):
        raise ValueError(f"perm words must be contiguous int32 "
                         f"(2, {KERNEL_PERMS}) on {seg.device}")
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        if k == KERNEL_SHINGLE:
            rc = _build.library().fdfs_sketch_ragged(
                seg.data_ptr(), offsets.data_ptr(), lens.data_ptr(),
                ptr(order), words.data_ptr(), n, sig.data_ptr(),
                sig.stride(0), ptr(z), stream)
        else:
            rc = _build.library().fdfs_sketch_ragged_k(
                seg.data_ptr(), offsets.data_ptr(), lens.data_ptr(),
                ptr(order), ptr(words), n, k, pow(int(_POLY_B), k, 1 << 32),
                ptr(sig), 0 if sig is None else sig.stride(0), ptr(z),
                stream)
    _build.check_launch(rc, "sketch_ragged" if k == KERNEL_SHINGLE
                        else "sketch_ragged_k")


def sketch_ragged_cuda(seg: torch.Tensor, offsets: torch.Tensor,
                       lens: torch.Tensor, words: torch.Tensor | None = None,
                       order: torch.Tensor | None = None,
                       out: torch.Tensor | None = None, row_tile: int = 256,
                       k: int = DEFAULT_SHINGLE, with_z: bool = False):
    """uint8 ``(S,)`` segment + int64 offsets, int32 lengths and an
    optional int32 order ``(N,)`` -> uint32 ``(N, 64)`` signatures at
    shingle width ``k``, bit-identical to ``ops.minhash.sketch_ragged``:
    one launch, the k = 5 kernel at k = 5 and the general kernel at any
    other ``k``, stage 4 fused in both.  With ``with_z``, ``(sig, z)``:
    the same launch also writes the uint32 ``(N, NUM_SEGMENTS)`` survivor
    vectors.

    ``words`` is ``ops.minhash.perm_words(64, device)``, built here if
    absent (a caller that signs many segments builds it once).  ``out``,
    if given, is an int32 ``(N, 64)`` view with unit column stride.
    ``row_tile`` only sizes the plain twin's tiles on the CPU.
    """
    check_ragged(seg, offsets, lens, order)
    n = offsets.shape[0]
    if out is None:
        out = torch.empty((n, KERNEL_PERMS), dtype=torch.int32,
                          device=seg.device)
    check_out(out, n, KERNEL_PERMS, seg.device)
    _check_k(k)
    if words is None:
        words = perm_words(KERNEL_PERMS, seg.device)
    z = None
    if seg.device.type == "cpu":
        sig, z = sketch_ragged(seg, offsets, lens, KERNEL_PERMS, k,
                               perms_from_words(words), row_tile, with_z=True)
        out.copy_(sig.view(torch.int32))
    else:
        if with_z:
            z = torch.empty((n, NUM_SEGMENTS), dtype=torch.int32,
                            device=seg.device)
        if n:
            _launch(seg, offsets, lens, order, words, out, z, k)
            sketch_ragged_cuda.launches += 1
    if with_z:
        return out.view(torch.uint32), z.view(torch.uint32)
    return out.view(torch.uint32)


sketch_ragged_cuda.launches = 0


def _survivors(seg, offsets, lens, order, k: int) -> torch.Tensor:
    """One launch of stages 1-3 over ragged chunks on the card: int32
    ``(N, NUM_SEGMENTS)`` ``z``, read back through the k = 5 kernel's
    ``z`` output at k = 5 (it signs as well), the general kernel's ``z``
    form at any other ``k``."""
    n = offsets.shape[0]
    z = torch.empty((n, NUM_SEGMENTS), dtype=torch.int32, device=seg.device)
    if k == KERNEL_SHINGLE:
        sig = torch.empty((n, KERNEL_PERMS), dtype=torch.int32,
                          device=seg.device)
        _launch(seg, offsets, lens, order,
                perm_words(KERNEL_PERMS, seg.device), sig, z, k)
    else:
        _launch(seg, offsets, lens, order, None, None, z, k)
    return z


def survivor_ragged_cuda(seg: torch.Tensor, offsets: torch.Tensor,
                         lens: torch.Tensor, k: int = DEFAULT_SHINGLE,
                         row_tile: int = 256,
                         order: torch.Tensor | None = None) -> torch.Tensor:
    """Stages 1-3 over ragged chunks at shingle width ``k``: uint32 ``(N,
    NUM_SEGMENTS)``, bit-identical to ``ops.minhash.survivor_ragged`` (the
    same signature, plus the optional int32 longest-first ``order``).  One
    launch: the k = 5 kernel's ``z`` output at k = 5, the general kernel's
    ``z`` form at any other ``k``.  The engine's path at a permutation
    count other than 64; stage 4 then runs on ``signature_tiles_cuda``.
    ``row_tile`` only sizes the plain twin's tiles on the CPU."""
    check_ragged(seg, offsets, lens, order)
    _check_k(k)
    if seg.device.type == "cpu":
        return survivor_ragged(seg, offsets, lens, k, row_tile)
    n = offsets.shape[0]
    if not n:
        return torch.empty((0, NUM_SEGMENTS), dtype=torch.uint32,
                           device=seg.device)
    z = _survivors(seg, offsets, lens, order, k)
    survivor_ragged_cuda.launches += 1
    return z.view(torch.uint32)


survivor_ragged_cuda.launches = 0


def _padded_launch(data, lengths, k: int) -> torch.Tensor:
    """The fused sketch over padded rows: int32 (N, 64) signatures."""
    n, L = data.shape
    dev = data.device
    sig = torch.empty((n, KERNEL_PERMS), dtype=torch.int32, device=dev)
    offsets = torch.arange(n, dtype=torch.int64, device=dev) * L
    _launch(data.reshape(-1), offsets, lengths.clamp(0, L), None,
            perm_words(KERNEL_PERMS, dev), sig, None, k)
    return sig


def survivor_segmin_cuda(data: torch.Tensor, lengths: torch.Tensor,
                         k: int = DEFAULT_SHINGLE) -> torch.Tensor:
    """uint8 ``(N, L)`` + int32 ``(N,)`` -> uint32 ``(N, NUM_SEGMENTS)``,
    bit-identical to ``ops.minhash.survivor_segmin``: stages 1-3 at
    shingle width ``k``, one launch of the kernels of
    ``survivor_ragged_cuda`` over the rows (``offsets = i * L``)."""
    check_batch(data, lengths)
    _check_k(k)
    if data.device.type == "cpu":
        return survivor_segmin(data, lengths, k)
    n, L = data.shape
    if not n:
        return torch.empty((0, NUM_SEGMENTS), dtype=torch.uint32,
                           device=data.device)
    offsets = torch.arange(n, dtype=torch.int64, device=data.device) * L
    z = _survivors(data.reshape(-1), offsets, lengths.clamp(0, L), None, k)
    survivor_segmin_cuda.launches += 1
    return z.view(torch.uint32)


survivor_segmin_cuda.launches = 0


def signature_tiles_cuda(z: torch.Tensor, words: torch.Tensor,
                         out: torch.Tensor | None = None,
                         row_tile: int = 256) -> torch.Tensor:
    """Stage 4 over survivor vectors: uint32 (or int32 bits) ``(N,
    NUM_SEGMENTS)`` ``z`` and int32 ``(2, P)`` permutation words (``a``
    then ``b``: ``perm_words``, or a rank's columns of it) -> uint32 ``(N,
    P)``, bit-identical to ``ops.minhash.signature_tiles``: the min over
    each row's non-EMPTY entries of ``a_j z + b_j`` mod 2**32, all-EMPTY
    for a row with none.  ``z`` needs unit column stride only.  ``out``,
    if given, is an int32 ``(N, P)`` view with unit column stride.
    ``row_tile`` only sizes the plain twin's tiles on the CPU."""
    if z.dtype == torch.uint32:
        z = z.view(torch.int32)
    if z.dtype != torch.int32 or z.ndim != 2 or z.shape[1] != NUM_SEGMENTS \
            or (z.shape[0] and z.stride(1) != 1):
        raise ValueError(f"z must be uint32 (N, {NUM_SEGMENTS}) with unit "
                         f"column stride, got {z.dtype} {tuple(z.shape)}")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {z.device}")
    if (words.dtype != torch.int32 or words.ndim != 2 or words.shape[0] != 2
            or words.shape[1] < 1 or words.device != z.device
            or not words.is_contiguous()):
        raise ValueError(f"perm words must be contiguous int32 (2, P >= 1) "
                         f"on {z.device}, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")
    n, p = z.shape[0], words.shape[1]
    if out is None:
        out = torch.empty((n, p), dtype=torch.int32, device=z.device)
    check_out(out, n, p, z.device)
    if z.device.type == "cpu":
        out.copy_(signature_tiles(z, p, perms_from_words(words),
                                  row_tile).view(torch.int32))
    elif n:
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            rc = _build.library().fdfs_minhash_sig(
                z.data_ptr(), z.stride(0), n, words.data_ptr(), p,
                out.data_ptr(), out.stride(0), stream)
        _build.check_launch(rc, "minhash_sig")
        signature_tiles_cuda.launches += 1
    return out.view(torch.uint32)


signature_tiles_cuda.launches = 0


def minhash_batch_cuda(data: torch.Tensor, lengths: torch.Tensor,
                       num_perms: int = DEFAULT_PERMS,
                       k: int = DEFAULT_SHINGLE) -> torch.Tensor:
    """Kernel-path twin of ``ops.minhash.minhash_batch`` (and of the
    reference's ``minhash_batch_pallas(data, lengths, num_perms, k)``):
    uint8 ``(N, L)`` + int32 ``(N,)`` -> uint32 ``(N, num_perms)`` at
    shingle width ``k``.  With 64 permutations one launch of the fused
    sketch signs the rows (the k = 5 kernel or the general one); with
    another count stages 1-3 yield ``z`` and stage 4 runs on
    ``signature_tiles_cuda``."""
    check_batch(data, lengths)
    _check_k(k)
    if data.device.type == "cpu":
        return minhash_batch(data, lengths, num_perms, k)
    if num_perms != KERNEL_PERMS:
        return signature_tiles_cuda(survivor_segmin_cuda(data, lengths, k),
                                    perm_words(num_perms, data.device))
    sig = torch.empty((data.shape[0], KERNEL_PERMS), dtype=torch.int32,
                      device=data.device)
    if data.shape[0]:
        sig = _padded_launch(data, lengths, k)
        minhash_batch_cuda.launches += 1
    return sig.view(torch.uint32)


minhash_batch_cuda.launches = 0
