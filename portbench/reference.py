"""The plain reference the benchmark holds the engine's answers to.

What ``DedupEngine.fingerprint(data, cuts)`` returns for one segment,
worked out again from the segment's bytes and cuts alone:

- the spans, ``(offset, length)`` of every chunk;
- each chunk's SHA-1 (``hashlib``), as five big-endian 32-bit words;
- each chunk's 64-permutation MinHash signature of the survivor sketch
  at shingle width 5, in NumPy:

  1. the polynomial hash (base 0x01000193, mod 2**32) of every 5-byte
     window, zero past the chunk's end;
  2. a window survives where its hash has its low 8 bits zero; only the
     windows that lie wholly inside the chunk count (a chunk shorter than
     5 bytes hashes its zero-padded windows at positions below its
     length);
  3. ``z[s]`` is the least survivor whose chunk-relative position ``p``
     has ``(p // 4) % 1024 == s``;
  4. signature ``j`` is the least ``a_j * z + b_j`` (mod 2**32) over the
     non-empty ``z``, or 0xFFFFFFFF where there is none.

The permutation constants are drawn as the sketch's specification draws
them (``RandomState(0x5F3759DF)``).  This module imports nothing of the
program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

SHINGLE = 5
PERMS = 64
POLY_B = 0x01000193
SAMPLE_MASK = 0xFF
NUM_SEGMENTS = 1024
EMPTY = 0xFFFFFFFF
_MINHASH_SEED = 0x5F3759DF
_TILE = 1 << 22


def perm_constants(num_perms: int = PERMS) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(_MINHASH_SEED & 0x7FFFFFFF)
    a = (rng.randint(0, 1 << 31, size=num_perms, dtype=np.uint64) * 2
         + 1).astype(np.uint32)
    b = rng.randint(0, 1 << 32, size=num_perms, dtype=np.uint64).astype(
        np.uint32)
    return a, b


def spans_of(cuts) -> tuple[np.ndarray, np.ndarray]:
    """int64 offsets and lengths of the chunks that end at ``cuts``."""
    ends = np.asarray(cuts, dtype=np.int64)
    lens = np.diff(ends, prepend=0)
    return ends - lens, lens


def sha1_words(seg: bytes, offsets: np.ndarray, lens: np.ndarray
               ) -> np.ndarray:
    """uint32 (N, 5): each chunk's SHA-1 as big-endian words."""
    view = memoryview(seg)
    raw = b"".join(hashlib.sha1(view[o:o + n]).digest()
                   for o, n in zip(offsets.tolist(), lens.tolist()))
    return np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(-1, 5)


def _window_hashes(buf: np.ndarray, lo: int, hi: int, k: int) -> np.ndarray:
    """uint32 hashes of the ``k``-byte windows starting at ``lo..hi-1``,
    zero past the end of ``buf``."""
    n = len(buf)
    with np.errstate(over="ignore"):
        h = np.zeros(hi - lo, dtype=np.uint32)
        for j in range(k):
            part = np.zeros(hi - lo, dtype=np.uint32)
            end = min(hi + j, n)
            if end > lo + j:
                part[:end - lo - j] = buf[lo + j:end]
            h *= np.uint32(POLY_B)
            h += part
    return h


def survivors(buf: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
              k: int = SHINGLE, sample_mask: int = SAMPLE_MASK
              ) -> tuple[np.ndarray, np.ndarray]:
    """Stages 1-3: the flat index ``chunk * 1024 + s`` of every non-empty
    ``z`` entry, ascending, and its value.  ``sample_mask`` is the
    specification's; only the control passes another."""
    n = len(buf)
    ends = offsets + lens
    keys, vals = [], []
    for lo in range(0, n, _TILE):
        hi = min(lo + _TILE, n)
        h = _window_hashes(buf, lo, hi, k)
        g = np.nonzero((h & np.uint32(sample_mask)) == 0)[0]
        hv = h[g]
        g = g.astype(np.int64) + lo
        c = np.searchsorted(ends, g, side="right")
        inside = c < len(lens)
        g, hv, c = g[inside], hv[inside], c[inside]
        p = g - offsets[c]
        ln = lens[c]
        # A chunk shorter than k hashes windows that run past its end,
        # which must read zeros, not the next chunk's bytes: below.
        valid = (ln >= k) & (p <= ln - k)
        keys.append(c[valid] * NUM_SEGMENTS + ((p[valid] >> 2)
                                               % NUM_SEGMENTS))
        vals.append(hv[valid])
    for c in np.nonzero(lens < k)[0].tolist():
        o, ln = int(offsets[c]), int(lens[c])
        chunk = np.frombuffer(buf[o:o + ln].tobytes(), dtype=np.uint8)
        h = _window_hashes(chunk, 0, max(ln, 1), k)
        pos = np.nonzero((h & np.uint32(sample_mask)) == 0)[0]
        keys.append(c * NUM_SEGMENTS + (pos.astype(np.int64) >> 2)
                    % NUM_SEGMENTS)
        vals.append(h[pos])
    key = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    val = np.concatenate(vals) if vals else np.zeros(0, np.uint32)
    order = np.lexsort((val, key))
    key, val = key[order], val[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    return key[first], val[first]


def signatures(key: np.ndarray, val: np.ndarray, n_chunks: int,
               a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Stage 4: uint32 (N, P) from the non-empty ``z`` entries."""
    sig = np.full((n_chunks, len(a)), EMPTY, dtype=np.uint32)
    if not len(key):
        return sig
    chunk = key // NUM_SEGMENTS
    starts = np.nonzero(np.r_[True, chunk[1:] != chunk[:-1]])[0]
    with np.errstate(over="ignore"):
        perm = a[:, None] * val[None, :] + b[:, None]          # (P, m)
    sig[chunk[starts]] = np.minimum.reduceat(perm, starts, axis=1).T
    return sig


@dataclass(frozen=True)
class Answer:
    """The reference's answer for one segment, and the survivor count the
    sketch's roofline takes."""

    offsets: np.ndarray
    lens: np.ndarray
    digests: np.ndarray
    sigs: np.ndarray
    survivors: int


def answer(seg: bytes, cuts, k: int = SHINGLE, perms: int = PERMS,
           sample_mask: int = SAMPLE_MASK) -> Answer:
    """Spans, digests and signatures of one segment under ``cuts``."""
    offsets, lens = spans_of(cuts)
    buf = np.frombuffer(seg, dtype=np.uint8)
    a, b = perm_constants(perms)
    key, val = survivors(buf, offsets, lens, k, sample_mask)
    return Answer(offsets, lens, sha1_words(seg, offsets, lens),
                  signatures(key, val, len(lens), a, b), len(key))
