"""MinHash near-duplicate fingerprints (v2 survivor sketch), plain PyTorch.

The twin of ``fastdfs_tpu/ops/minhash.py``; the spec is the same and the
outputs are bit-identical:

1. **Shingle hashes**: polynomial hash (base ``_POLY_B``, mod 2**32) of
   every ``k``-byte window;
2. **Survivor sampling**: keep hashes with ``h & SAMPLE_MASK == 0``;
3. **Segment-min compaction**: ``z[s]`` is the smallest survivor whose
   byte position ``p`` has ``(p // 4) % NUM_SEGMENTS == s``, else
   ``EMPTY``;
4. **Permutation MinHash over survivors**: ``P`` universal hashes
   ``a_j * x + b_j`` min-reduced over the non-``EMPTY`` entries of ``z``.

The CUDA sketch kernels (``cuda_minhash``) compute all four stages in
one pass over ragged chunks at any ``k``, or stages 1-3 alone; this
module is their reference (``sketch_ragged``, ``survivor_ragged``) and
the path a CPU tensor takes.  Words are int64
masked to 32 bits inside;
public functions return uint32 tensors (see ``ops/__init__.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fastdfs_tpu_torch.ops import (MASK32, mean_of_count, mul32, narrow,
                                   ragged_batches, split16, widen)

DEFAULT_SHINGLE = 5
DEFAULT_PERMS = 64

SAMPLE_MASK = np.uint32(0xFF)   # keep h iff (h & SAMPLE_MASK) == 0: rate 1/256
NUM_SEGMENTS = 1024             # z width; segment = word_index % NUM_SEGMENTS
EMPTY = np.uint32(0xFFFFFFFF)   # empty-segment sentinel, neutral under min

_MINHASH_SEED = 0x5F3759DF
_POLY_B = np.uint32(0x01000193)  # FNV-32 prime as shingle-hash base

_MIN_BLOCK = 512  # positions per running-min step: a (P, block) tile, never (P, m)


def _perm_constants(num_perms: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(_MINHASH_SEED & 0x7FFFFFFF)
    a = (rng.randint(0, 1 << 31, size=num_perms, dtype=np.uint64) * 2 + 1).astype(np.uint32)
    b = rng.randint(0, 1 << 32, size=num_perms, dtype=np.uint64).astype(np.uint32)
    return a, b


def perm_tensors(num_perms: int, device: str | torch.device,
                 lanes: slice = slice(None)
                 ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Stage 4's permutation constants on ``device``: ``a`` as its
    ``split16`` halves and ``b``, each (P, 1) int64, or only the
    permutations in ``lanes`` (a tensor-parallel rank's share).  A caller
    that signs many batches builds them once (``DedupEngine`` does): a
    copy from host memory per call would also stall the host behind the
    device's queue."""
    a, b = (c[lanes] for c in _perm_constants(num_perms))
    av = torch.as_tensor(a.astype(np.int64), device=device)[:, None]
    bv = torch.as_tensor(b.astype(np.int64), device=device)[:, None]
    return split16(av), bv


def perm_words(num_perms: int, device: str | torch.device) -> torch.Tensor:
    """Stage 4's constants as the sketch kernel reads them: int32 (2, P),
    the uint32 bit patterns of ``a`` then ``b``."""
    a, b = _perm_constants(num_perms)
    return torch.as_tensor(np.stack([a, b]).view(np.int32), device=device)


def perms_from_words(words: torch.Tensor):
    """``perm_words`` -> the ``perm_tensors`` form the plain stage 4 takes."""
    a = widen(words[0])[:, None]
    return split16(a), widen(words[1])[:, None]


def _shingle_hashes(d: torch.Tensor, k: int) -> torch.Tensor:
    """int64 bytes (..., n) -> int64 hashes (..., n); entry i hashes
    ``d[i:i+k]`` with zeros past the end."""
    n = d.shape[-1]
    h = torch.zeros_like(d)
    for j in range(k):
        if j == 0:
            shifted = d
        else:
            shifted = torch.zeros_like(d)
            if j < n:
                shifted[..., :n - j] = d[..., j:]
        h = (h * int(_POLY_B) + shifted) & MASK32
    return h


def shingle_hashes(data, k: int = DEFAULT_SHINGLE) -> torch.Tensor:
    """Polynomial hashes of all ``k``-byte shingles of uint8 ``(..., n)``
    data, along the last axis.  Returns uint32 ``(..., n)``; the trailing
    ``k-1`` entries hash the zero-padded suffix, as in the reference."""
    d = torch.as_tensor(data, dtype=torch.uint8).to(torch.int64)
    return narrow(_shingle_hashes(d, k))


def _valid_mask(n: int, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """(N, n) bool: complete-shingle positions (degenerate chunks shorter
    than ``k`` hash their zero-padded window at positions < max(len, 1))."""
    pos = torch.arange(n, device=lengths.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = pos <= (lens - k)
    return torch.where(lens >= k, valid, pos < lens.clamp(min=1))


def _survivor_segmin(data: torch.Tensor, lengths: torch.Tensor,
                     k: int) -> torch.Tensor:
    n, L = data.shape
    block = 4 * NUM_SEGMENTS
    pad = (-L) % block
    h = _shingle_hashes(F.pad(data, (0, pad)).to(torch.int64), k)
    surv = _valid_mask(L + pad, lengths, k) & ((h & int(SAMPLE_MASK)) == 0)
    hm = torch.where(surv, h, int(EMPTY))
    # position p = block*b + 4*s + r  ->  word p//4 = NUM_SEGMENTS*b + s,
    # so a plain reshape groups positions by segment.
    return hm.reshape(n, (L + pad) // block, NUM_SEGMENTS, 4).amin(dim=(1, 3))


def survivor_segmin(data, lengths, k: int = DEFAULT_SHINGLE) -> torch.Tensor:
    """Stages 1-3 of the sketch: uint8 ``(N, L)`` + lengths ``(N,)`` ->
    uint32 ``(N, NUM_SEGMENTS)`` survivor vector ``z``, on the data's device.

    CONTRACT: rows are zero past their length (shared with ``sha1_batch``).

    The plain twin of the sketch kernels' stages 1-3
    (``cuda_minhash.survivor_segmin_cuda``); ``survivor_segmin.cuda_calls``
    counts its calls on a CUDA tensor, which the card's paths leave to the
    kernels.
    """
    data = torch.as_tensor(data, dtype=torch.uint8)
    if data.device.type == "cuda":
        survivor_segmin.cuda_calls += 1
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=data.device)
    return narrow(_survivor_segmin(data, lengths, k))


survivor_segmin.cuda_calls = 0


def minhash_signature(hashes: torch.Tensor, num_perms: int = DEFAULT_PERMS,
                      valid: torch.Tensor | None = None, perms=None
                      ) -> torch.Tensor:
    """MinHash signature of element hashes (stage 4), batched over leading
    axes: uint32 ``(..., m)`` (+ optional bool ``valid`` of the same shape)
    -> uint32 ``(..., num_perms)``.  All-invalid input signs as all-EMPTY.
    ``perms`` is ``perm_tensors(num_perms, device)``, built here if absent.

    A running min over 512-position blocks: the ``(P, m)`` permuted matrix
    is never built.
    """
    h = widen(hashes)
    dev = h.device
    if perms is None:
        perms = perm_tensors(num_perms, dev)
    a, bv = perms                                                     # (P,1)
    if bv.shape[0] != num_perms:
        raise ValueError(f"perms hold {bv.shape[0]} permutations, "
                         f"not {num_perms}")
    m = h.shape[-1]
    sig = torch.full((*h.shape[:-1], num_perms), int(EMPTY),
                     dtype=torch.int64, device=dev)
    for start in range(0, m, _MIN_BLOCK):
        hb = h[..., None, start:start + _MIN_BLOCK]                   # (...,1,B)
        perm = mul32(hb, a, bv)                                       # (...,P,B)
        if valid is not None:
            vb = valid[..., None, start:start + _MIN_BLOCK]
            perm = torch.where(vb, perm, int(EMPTY))
        sig = torch.minimum(sig, perm.amin(dim=-1))
    return narrow(sig)


def minhash_batch(data, lengths, num_perms: int = DEFAULT_PERMS,
                  k: int = DEFAULT_SHINGLE, perms=None) -> torch.Tensor:
    """Signatures for a batch of chunks: uint8 ``(N, L)`` + lengths ``(N,)``
    -> uint32 ``(N, num_perms)``.  Rows must be zero past their length."""
    z = widen(survivor_segmin(data, lengths, k))
    return minhash_signature(z, num_perms, z != int(EMPTY), perms)


def survivor_ragged(seg: torch.Tensor, offsets: torch.Tensor,
                    lens: torch.Tensor, k: int = DEFAULT_SHINGLE,
                    row_tile: int = 256) -> torch.Tensor:
    """Stages 1-3 of ragged chunks: uint8 ``(S,)`` segment + int64 offsets
    and int32 lengths ``(N,)`` -> uint32 ``(N, NUM_SEGMENTS)``.  The
    chunks go through ``survivor_segmin`` in zero-padded
    ``(row_tile, bucket)`` tiles (``ops.ragged_batches``).

    The plain twin of ``cuda_minhash.survivor_ragged_cuda``;
    ``survivor_ragged.cuda_calls`` counts its calls on a CUDA tensor."""
    if seg.device.type == "cuda":
        survivor_ragged.cuda_calls += 1
    z = torch.zeros((offsets.shape[0], NUM_SEGMENTS), dtype=torch.int64,
                    device=seg.device)
    for rows, batch, ln in ragged_batches(seg, offsets, lens, row_tile):
        z[rows] = widen(survivor_segmin(batch, ln, k))
    return narrow(z)


survivor_ragged.cuda_calls = 0


def signature_tiles(z: torch.Tensor, num_perms: int = DEFAULT_PERMS,
                    perms=None, row_tile: int = 256) -> torch.Tensor:
    """Stage 4 over survivor vectors, ``row_tile`` rows at a time (the
    ``(rows, P, 512)`` intermediate stays small): uint32
    ``(N, NUM_SEGMENTS)`` -> uint32 ``(N, num_perms)``.

    The plain twin of ``csrc/minhash_sig.cu``
    (``cuda_minhash.signature_tiles_cuda``); ``signature_tiles.cuda_calls``
    counts its calls on a CUDA tensor, which the card's paths leave to the
    kernel."""
    if z.device.type == "cuda":
        signature_tiles.cuda_calls += 1
    if perms is None:
        perms = perm_tensors(num_perms, z.device)
    sig = torch.empty((z.shape[0], num_perms), dtype=torch.int32,
                      device=z.device)
    for start in range(0, z.shape[0], row_tile):
        zt = widen(z[start:start + row_tile])
        sig[start:start + row_tile] = minhash_signature(
            zt, num_perms, zt != int(EMPTY), perms).view(torch.int32)
    return sig.view(torch.uint32)


signature_tiles.cuda_calls = 0


def sketch_ragged(seg: torch.Tensor, offsets: torch.Tensor,
                  lens: torch.Tensor, num_perms: int = DEFAULT_PERMS,
                  k: int = DEFAULT_SHINGLE, perms=None, row_tile: int = 256,
                  with_z: bool = False):
    """Signatures of ragged chunks (the fused sketch kernel's plain twin):
    uint8 ``(S,)`` segment + int64 offsets and int32 lengths ``(N,)`` ->
    uint32 ``(N, num_perms)``, and with ``with_z`` also the uint32
    ``(N, NUM_SEGMENTS)`` survivor vectors: ``survivor_ragged`` then
    ``signature_tiles``."""
    z = survivor_ragged(seg, offsets, lens, k, row_tile)
    sig = signature_tiles(z, num_perms, perms, row_tile)
    return (sig, z) if with_z else sig


def estimate_jaccard(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
    """Agreement fraction of two signatures ≈ Jaccard similarity:
    ``(…, P)`` vs ``(…, P)`` -> ``(…,)`` float32."""
    eq = widen(sig_a) == widen(sig_b)
    return mean_of_count(eq.sum(dim=-1), eq.shape[-1])

