"""The plain reference of a crawler's upload session on a node's sidecar
(``calls/neardup_session.py``): what the sidecar must answer for a page,
worked out from bytes alone.

- a page's spans and digests, and each chunk's signature:
  ``portbench.reference.answer``, the sketch from its specification;
- the page's file signature: per permutation, the least over its chunks'
  signatures (the MinHash of the union of their sketches);
- a stored page's cuts, as the storage daemon makes them: the gear hash
  of ``portbench.cdc`` (the fmix32 table, the 32-byte window) in NumPy,
  and ``cdc.select_cuts`` on the page alone;
- the LSH rule of the sidecar's near-dup report: the signature in
  ``bands`` bands of equal rows; another file is reported where some
  band is equal byte for byte and the score, the float32 mean of the
  permutations that agree, is at least the threshold; the score is
  printed with 4 places.

It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import cdc
from portbench import reference as plain


@dataclass(frozen=True)
class Answer:
    """A page's spans, digests and file signature, its sketch's survivor
    count (which the sketch's roofline takes), and the stored pages its
    report must list, as (stored page, score) pairs; ``bands`` and
    ``threshold`` are the rule's."""

    offsets: np.ndarray
    lens: np.ndarray
    digests: np.ndarray
    sig: np.ndarray
    survivors: int
    stored: frozenset
    bands: int
    threshold: float


def gear_candidates(data: bytes, avg_bits: int) -> np.ndarray:
    """Positions whose 32-byte windowed gear hash has its low
    ``avg_bits`` bits zero: h[i] = sum over the window of
    gear[byte] << distance, mod 2**32, by prefix doubling."""
    h = cdc.GEAR_TABLE[np.frombuffer(data, dtype=np.uint8)]
    w = 1
    while w < cdc.WINDOW:
        shifted = np.zeros_like(h)
        shifted[w:] = h[:-w]
        h = h + (shifted << np.uint32(w))
        w <<= 1
    return np.flatnonzero((h & np.uint32((1 << avg_bits) - 1)) == 0)


def cuts(data: bytes, dedup: dict) -> list[int]:
    return cdc.select_cuts(gear_candidates(data, dedup["avg_bits"]),
                           len(data), dedup["min_size"], dedup["max_size"])


def signature(data: bytes, dedup: dict) -> np.ndarray:
    """The file signature of a page under its own cuts."""
    ans = plain.answer(data, cuts(data, dedup), dedup["shingle"],
                       dedup["num_perms"])
    return ans.sigs.min(axis=0)


def reported(a: np.ndarray, b: np.ndarray, bands: int, threshold: float
             ) -> str | None:
    """The score a report of ``a`` prints for a file signed ``b``, or None
    where the rule leaves it out."""
    if not (a.reshape(bands, -1) == b.reshape(bands, -1)).all(axis=1).any():
        return None
    score = np.float32(np.count_nonzero(a == b)) / np.float32(len(a))
    return f"{float(score):.4f}" if score >= threshold else None


def answer(data: bytes, page_cuts, stored: dict[int, np.ndarray],
           dedup: dict, bands: int, threshold: float) -> Answer:
    """The answer for a page cut at ``page_cuts``, against the stored
    pages ``stored`` (stored page: its file signature)."""
    ans = plain.answer(data, page_cuts, dedup["shingle"], dedup["num_perms"])
    sig = ans.sigs.min(axis=0)
    pairs = ((j, reported(sig, s, bands, threshold))
             for j, s in stored.items())
    return Answer(ans.offsets, ans.lens, ans.digests, sig, ans.survivors,
                  frozenset((j, r) for j, r in pairs if r is not None),
                  bands, threshold)
