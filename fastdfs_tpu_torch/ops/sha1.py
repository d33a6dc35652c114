"""Batched SHA-1 in plain PyTorch: the twin of ``fastdfs_tpu/ops/sha1.py``.

SHA-1's 80 rounds are sequential within a message, so the batch is
parallel across rows: every row carries its own 5-word state and all
rows step through the rounds together.  Per-row Merkle–Damgård padding
(0x80, zeros, 64-bit big-endian bit length) is applied with index masks
so rows of different lengths share one fixed shape; blocks past a row's
padded length leave its state untouched.

This is the reference the CUDA kernel (``cuda_sha1``) is held to, and
the path a CPU tensor takes.  Words are int64 masked to 32 bits (see
``ops/__init__.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from fastdfs_tpu_torch.ops import MASK32, narrow, ragged_batches, widen

_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _compress_block(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One SHA-1 compression: ``state`` (N,5), ``words`` (N,16), int64."""
    w = [words[:, t] for t in range(16)]
    for t in range(16, 80):
        w.append(_rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
    a, b, c, d, e = state.unbind(1)
    for t in range(80):
        if t < 20:
            f = (b & c) | ((b ^ MASK32) & d)
        elif t < 40:
            f = b ^ c ^ d
        elif t < 60:
            f = (b & c) | (b & d) | (c & d)
        else:
            f = b ^ c ^ d
        tmp = (_rotl(a, 5) + f + e + _K[t // 20] + w[t]) & MASK32
        a, b, c, d, e = tmp, a, _rotl(b, 30), c, d
    return (state + torch.stack([a, b, c, d, e], dim=1)) & MASK32


def _sha1_padded(data: torch.Tensor, lengths: torch.Tensor,
                 max_len: int) -> torch.Tensor:
    """uint8 (N, L) + lengths (N,) -> int64 (N, 5) digest words."""
    n = data.shape[0]
    dev = data.device
    max_blocks = (max_len + 8) // 64 + 1
    padded_len = max_blocks * 64

    buf = torch.zeros((n, padded_len), dtype=torch.uint8, device=dev)
    buf[:, :data.shape[1]] = data
    idx = torch.arange(padded_len, device=dev)[None, :]            # (1,P)
    lens = lengths.to(device=dev, dtype=torch.int64)[:, None]       # (N,1)
    n_blocks = (lens + 8) // 64 + 1                                 # (N,1)
    msg_end = n_blocks * 64

    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    buf = torch.where(idx < lens, buf, zero)
    buf = torch.where(idx == lens, torch.full_like(zero, 0x80), buf)

    # 64-bit big-endian bit length in the last 8 bytes of the final block.
    byte_pos = idx - (msg_end - 8)                                  # 0..7
    in_field = (byte_pos >= 0) & (byte_pos < 8)
    shift = (7 - byte_pos.clamp(0, 7)) * 8
    len_byte = (((lens * 8) >> shift) & 0xFF).to(torch.uint8)
    buf = torch.where(in_field, len_byte, buf)

    # Big-endian 4-byte words: (N, max_blocks, 16).
    quads = buf.reshape(n, max_blocks, 16, 4).to(torch.int64)
    words = ((quads[..., 0] << 24) | (quads[..., 1] << 16)
             | (quads[..., 2] << 8) | quads[..., 3])

    state = torch.tensor(_H0, dtype=torch.int64, device=dev).expand(n, 5)
    # Blocks past every row's own padded length change nothing: stop at
    # the longest row's.
    used = int(n_blocks.max()) if n else 0
    for blk in range(min(max_blocks, used)):
        new_state = _compress_block(state, words[:, blk])
        state = torch.where(blk < n_blocks, new_state, state)
    return state


def sha1_batch(data, lengths=None) -> torch.Tensor:
    """SHA-1 digests for a batch of chunks.

    ``data``: uint8 ``(N, L)`` tensor or array, rows zero-padded past each
    chunk's length.  ``lengths``: int ``(N,)`` true byte lengths (default L
    for every row).  Returns uint32 ``(N, 5)`` digest words on the data's
    device.
    """
    data = torch.as_tensor(data, dtype=torch.uint8)
    if data.ndim != 2:
        raise ValueError(f"expected (N, L) batch, got shape {tuple(data.shape)}")
    if lengths is None:
        lengths = torch.full((data.shape[0],), data.shape[1],
                             dtype=torch.int32, device=data.device)
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=data.device)
    return narrow(_sha1_padded(data, lengths, int(data.shape[1])))


def sha1_ragged(seg: torch.Tensor, offsets: torch.Tensor, lens: torch.Tensor,
                row_tile: int = 256) -> torch.Tensor:
    """Digests of ragged chunks (the ragged kernel's plain twin): uint8
    ``(S,)`` segment + int64 offsets and int32 lengths ``(N,)`` -> uint32
    ``(N, 5)``.  The chunks go through ``sha1_batch`` in zero-padded
    ``(row_tile, bucket)`` tiles (``ops.ragged_batches``)."""
    out = torch.zeros((offsets.shape[0], 5), dtype=torch.int64,
                      device=seg.device)
    for rows, batch, ln in ragged_batches(seg, offsets, lens, row_tile):
        out[rows] = widen(sha1_batch(batch, ln))
    return narrow(out)


def _host_u32(digest_words) -> np.ndarray:
    if isinstance(digest_words, torch.Tensor):
        digest_words = digest_words.detach().cpu().numpy()
    return np.asarray(digest_words, dtype=np.uint32)


def sha1_hex(digest_words) -> str:
    """Render one (5,) uint32 digest row as the canonical 40-char hex."""
    return b"".join(int(w).to_bytes(4, "big")
                    for w in _host_u32(digest_words)).hex()


def digest_bytes(digest_words) -> bytes:
    """(…,5) uint32 digest rows -> concatenated 20-byte big-endian digests."""
    return _host_u32(digest_words).astype(">u4").tobytes()
