"""Reed-Solomon RS(k, m) erasure coding over GF(2^8): the port of
``fastdfs_tpu/ops/rs_code.py``.

Encode and reconstruct are one primitive, a (rows x k) GF(2^8) matrix
applied to k shards of length L:

    out[r, l] = XOR_i  mul(M[r, i], shards[i, l])

in three disciplines:

- ``gf_matmul_ref``: serial Python referee (copied).
- ``gf_matmul_np``: tiled NumPy product-table gather, XOR-reduced over k
  (copied).
- ``gf_matmul``: on the caller's device, in place of the reference's
  XLA ``_gf_matmul_jit`` (rs_code.py:170-206), which is not a Pallas
  kernel.  A CUDA tensor goes to the hand-written kernel
  ``ops.cuda_gf.gf_matmul_cuda`` (``csrc/gf_matmul.cu``: products in
  registers from small per-coefficient tables, one launch per call); a
  CPU tensor to its plain twin ``gf_matmul_torch``.
- ``gf_matmul_torch``: the plain PyTorch twin.  The product-table rows
  of the matrix's coefficients, ``(k, rows, 256)`` uint8 (at most 64 KiB,
  the whole table's size), go to the shards' device in one copy per
  call.  torch has no XOR reduction, so the loop runs over the k
  columns: gather column i's ``(rows, L)`` products at shard i's bytes
  and ``bitwise_xor_`` them into the output, about 2k device kernels a
  call.  No ``(rows, k, L)`` intermediate exists (at k = 32 and a 64 MB
  stripe it would be 16 GB), and no power-of-two pad: that served XLA's
  compile-once shapes.

Bound on an H100: ``(k + rows) * L`` bytes over the memory rate, or its
``rows * k * L`` products where they take longer (``chip_smoke.py``
computes both; PERF.md has the measured times).

The generator matrix is systematic Cauchy ([I; C] with C[j][i] =
inv(x_i ^ a_j), x_i = i, a_j = k + j), so every k x k submatrix inverts
and any k surviving shards rebuild the stripe; ``decode_matrix`` inverts
the surviving rows by Gauss-Jordan on the host (k <= 32; PERF.md has
its time beside the product's).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fastdfs_tpu_torch.ops import cuda_gf, resolve_device
from fastdfs_tpu_torch.ops.gf256 import (GF_EXP, GF_LOG, cauchy_coeff,
                                         gf_inv, gf_mul)

# RS geometry bounds.  k + m <= 255 is the field limit (Cauchy points
# must be distinct bytes); the practical clamp lives in storage config
# (ec_k <= 32, ec_m <= 8).
MAX_SHARDS = 255

# 256x256 product table: PROD[a, b] = a * b in GF(2^8), 64 KiB.
_EXP = np.asarray(GF_EXP, dtype=np.uint8)
_LOG = np.asarray(GF_LOG, dtype=np.int32)
PROD_TABLE = _EXP[_LOG[:, None] + _LOG[None, :]]
PROD_TABLE[0, :] = 0
PROD_TABLE[:, 0] = 0

# NumPy tiling: columns per tile, so the (rows, k, tile) gather stays
# cache-sized.
_NP_TILE = 32 << 10


# ---------------------------------------------------------------------------
# Generator / decode matrices (host-side, tiny)
# ---------------------------------------------------------------------------

def parity_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) systematic Cauchy parity coefficients for RS(k, m)."""
    if k <= 0 or m < 0 or k + m > MAX_SHARDS:
        raise ValueError(f"bad RS geometry k={k} m={m}")
    return np.array([[cauchy_coeff(k, j, i) for i in range(k)]
                     for j in range(m)], dtype=np.uint8)


def encode_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) full generator [I; C]: row s of the product is shard s."""
    return np.concatenate([np.eye(k, dtype=np.uint8), parity_matrix(k, m)])


def gf_invert_matrix(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a k x k matrix over GF(2^8).

    Raises ValueError on a singular matrix — impossible for Cauchy
    submatrices, so hitting it means corrupted shard indices.
    """
    a = np.array(a, dtype=np.uint8, copy=True)
    k = a.shape[0]
    if a.shape != (k, k):
        raise ValueError(f"not square: {a.shape}")
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        pivot = next((r for r in range(col, k) if a[r, col]), None)
        if pivot is None:
            raise ValueError(f"singular at column {col}")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        scale = gf_inv(int(a[col, col]))
        a[col] = PROD_TABLE[scale, a[col]]
        inv[col] = PROD_TABLE[scale, inv[col]]
        for r in range(k):
            f = int(a[r, col])
            if r != col and f:
                a[r] ^= PROD_TABLE[f, a[col]]
                inv[r] ^= PROD_TABLE[f, inv[col]]
    return inv


def decode_matrix(k: int, m: int, present: "list[int]") -> np.ndarray:
    """(k, k) matrix mapping k surviving shards back to the data shards.

    ``present`` names the k surviving shard indices (0..k-1 data,
    k..k+m-1 parity), in the order their rows will be stacked.
    """
    if len(present) != k:
        raise ValueError(f"need exactly k={k} present shards, got "
                         f"{len(present)}")
    if len(set(present)) != k or not all(0 <= s < k + m for s in present):
        raise ValueError(f"bad present set {present}")
    gen = encode_matrix(k, m)
    return gf_invert_matrix(gen[np.asarray(present, dtype=np.intp)])


# ---------------------------------------------------------------------------
# The GF matmul, three ways
# ---------------------------------------------------------------------------

def gf_matmul_ref(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Serial referee: out[r, l] = XOR_i mul(M[r, i], shards[i, l])."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    shards = np.atleast_2d(np.asarray(shards, dtype=np.uint8))
    rows, k = matrix.shape
    if shards.shape[0] != k:
        raise ValueError(f"matrix k={k} vs shards {shards.shape}")
    out = np.zeros((rows, shards.shape[1]), dtype=np.uint8)
    for r in range(rows):
        for i in range(k):
            c = int(matrix[r, i])
            for col in range(shards.shape[1]):
                out[r, col] ^= gf_mul(c, int(shards[i, col]))
    return out


def gf_matmul_np(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Tiled NumPy path: product-table gather + XOR reduce over k."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    shards = np.atleast_2d(np.ascontiguousarray(shards, dtype=np.uint8))
    rows, k = matrix.shape
    if shards.shape[0] != k:
        raise ValueError(f"matrix k={k} vs shards {shards.shape}")
    length = shards.shape[1]
    out = np.empty((rows, length), dtype=np.uint8)
    for lo in range(0, length, _NP_TILE):
        tile = shards[:, lo:lo + _NP_TILE]        # (k, T)
        # (rows, k, T) product gather, XOR-reduced across the k axis
        prod = PROD_TABLE[matrix[:, :, None], tile[None, :, :]]
        out[:, lo:lo + _NP_TILE] = np.bitwise_xor.reduce(prod, axis=1)
    return out


def gf_matmul_torch(matrix: np.ndarray, shards: torch.Tensor
                    ) -> torch.Tensor:
    """The plain PyTorch twin of ``csrc/gf_matmul.cu``: a host ``(rows,
    k)`` matrix and uint8 ``(k, L)`` shards -> uint8 ``(rows, L)`` on the
    shards' device.  ``gf_matmul_torch.cuda_calls`` counts its calls on a
    CUDA tensor, which the card's paths leave to the kernel."""
    if shards.device.type == "cuda":
        gf_matmul_torch.cuda_calls += 1
    matrix = np.asarray(matrix, dtype=np.uint8)
    rows, k = matrix.shape
    dev = shards.device
    out = torch.zeros((rows, shards.shape[1]), dtype=torch.uint8, device=dev)
    if shards.shape[1]:
        # prods[i, r, b] = M[r, i] * b: column i's products for every row.
        prods = torch.from_numpy(PROD_TABLE[matrix.T]).to(dev)
        for i in range(k):
            out.bitwise_xor_(prods[i].index_select(
                1, shards[i].to(torch.int32)))
    return out


gf_matmul_torch.cuda_calls = 0


def gf_matmul(matrix: np.ndarray, shards, device: str | torch.device = "cuda"):
    """The GF(2^8) product of a host ``(rows, k)`` matrix and ``(k, L)``
    uint8 shards through ``cuda_gf.gf_matmul_cuda``: the kernel on a CUDA
    tensor, the plain twin on a CPU one.

    NumPy shards are copied to ``device`` (``cuda`` unless the caller
    passes ``cpu``) and the result comes back as NumPy; a tensor is
    computed on its own device and the result stays there.  Zero-length
    shards give ``(rows, 0)``.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    k = matrix.shape[1]
    as_numpy = not isinstance(shards, torch.Tensor)
    if as_numpy:
        dev = resolve_device(device)
        shards = torch.from_numpy(
            np.atleast_2d(np.ascontiguousarray(shards, dtype=np.uint8)))
    else:
        dev = shards.device
        shards = torch.atleast_2d(shards)
        if shards.dtype != torch.uint8:
            raise ValueError(f"shards must be uint8, got {shards.dtype}")
    if shards.shape[0] != k:
        raise ValueError(f"matrix k={k} vs shards {tuple(shards.shape)}")
    out = cuda_gf.gf_matmul_cuda(matrix, shards.to(dev))
    return out.cpu().numpy() if as_numpy else out


# ---------------------------------------------------------------------------
# Stripe-level helpers
# ---------------------------------------------------------------------------

def split_stripe(data: bytes, k: int) -> np.ndarray:
    """(k, shard_len) data shards: concatenated payload bytes split into
    k equal shards, the last zero-padded (shard_len = ceil(len/k); the
    on-disk manifest records the true data_len so padding never leaks
    back out).  Empty input yields shard_len 0."""
    if k <= 0:
        raise ValueError(f"bad k={k}")
    shard_len = -(-len(data) // k) if data else 0
    buf = np.zeros(k * shard_len, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(k, shard_len)


def _matmul(path: str, device: str | torch.device):
    if path == "torch":
        return functools.partial(gf_matmul, device=device)
    if path == "np":
        return gf_matmul_np
    if path == "ref":
        return gf_matmul_ref
    raise ValueError(f"unknown path {path!r}: one of 'ref', 'np', 'torch'")


def rs_encode(data_shards, m: int, path: str = "torch",
              device: str | torch.device = "cuda"):
    """(m, shard_len) parity shards for (k, shard_len) data shards.

    ``path="torch"`` runs ``gf_matmul`` (NumPy in, NumPy out, computed on
    ``device``, on the kernel where that is a card; a tensor stays on its
    device); ``"np"`` and ``"ref"`` are the host twins and ignore
    ``device``.
    """
    fn = _matmul(path, device)
    k = len(data_shards) if np.ndim(data_shards) == 2 else 1
    return fn(parity_matrix(k, m), data_shards)


def rs_reconstruct(present_shards, present: "list[int]", k: int, m: int,
                   path: str = "torch",
                   device: str | torch.device = "cuda"):
    """All k data shards from any k surviving shards.

    ``present_shards`` rows correspond 1:1 to the ``present`` indices
    (data rows 0..k-1, parity rows k..k+m-1, any order).  ``path`` and
    ``device`` as in ``rs_encode``.
    """
    fn = _matmul(path, device)
    return fn(decode_matrix(k, m, present), present_shards)
