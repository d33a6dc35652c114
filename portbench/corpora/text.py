"""The ``text`` corpus: web-text-like prose (``bench_configs._text_corpus``).

Words ``w0`` .. ``w<vocabulary-1>`` in sentences of 6-18 words, each
word followed by a space and each sentence's last by ". "; a part is one
of the shared sections with odds ``shared_odds``, else a run of fresh
prose.  A fresh run is cut from a stream of whole sentences, so it may
start mid-sentence (the reference starts each run on a sentence).  Every
segment is full.
"""

from __future__ import annotations

import numpy as np

# The widest token: "w" + 4 digits + ". ".
_TOKEN_WIDTH = 7


class _Words:
    """Every word as it may appear in prose: row ``j`` is word ``j`` and a
    space, row ``V + j`` is word ``j`` and ". " (a sentence's end)."""

    def __init__(self, vocabulary: int):
        words = [f"w{j}".encode() for j in range(vocabulary)]
        rows = [w + b" " for w in words] + [w + b". " for w in words]
        if max(map(len, rows)) > _TOKEN_WIDTH:
            raise ValueError(f"vocabulary {vocabulary} is too wide")
        self.vocabulary = vocabulary
        self.table = np.zeros((len(rows), _TOKEN_WIDTH), dtype=np.uint8)
        self.lens = np.array([len(r) for r in rows], dtype=np.int64)
        for i, r in enumerate(rows):
            self.table[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        self.mean_len = float(self.lens[:vocabulary].mean()) + 0.1


def _prose(rng: np.random.Generator, words: _Words, n: int,
           sentence: tuple[int, int]) -> np.ndarray:
    """``n`` bytes of prose: seeded words in seeded sentence lengths."""
    out = []
    have = 0
    while have < n:
        tokens = int((n - have) / words.mean_len) + 64
        ids = rng.integers(0, words.vocabulary, tokens)
        lens = rng.integers(sentence[0], sentence[1] + 1,
                            tokens // sentence[0] + 1)
        ends = np.cumsum(lens) - 1
        ends = ends[ends < tokens]
        ids[ends] += words.vocabulary
        # Trim the tail after the last full sentence.
        ids = ids[:int(ends[-1]) + 1] if len(ends) else ids
        keep = np.arange(_TOKEN_WIDTH) < words.lens[ids][:, None]
        part = words.table[ids][keep]
        out.append(part)
        have += len(part)
    return np.concatenate(out)[:n]


def _plan(c: dict, segment_bytes: int, plan: np.random.Generator
          ) -> list[tuple[int, int]]:
    """(kind, size) parts of one segment: kind 0 a shared section (size
    unknown until the seed picks it; sized here by the mean), 1 fresh."""
    lo, hi = c["shared_bytes"]
    f_lo, f_hi = c["fresh_bytes"]
    parts, size = [], 0
    while size < segment_bytes:
        if plan.random() < c["shared_odds"]:
            parts.append((0, 0))
            size += (lo + hi) // 2
        else:
            n = int(plan.integers(f_lo, f_hi + 1))
            parts.append((1, n))
            size += n
    return parts


def setup(made, plan: np.random.Generator, shared: np.random.Generator
          ) -> None:
    c = made.c
    made.words = _Words(c["vocabulary"])
    lo, hi = c["shared_bytes"]
    made.shared = [
        _prose(shared, made.words, int(shared.integers(lo, hi + 1)),
               tuple(c["sentence_words"]))
        for _ in range(c["shared_sections"])]
    made.plans = [_plan(c, made.segment_bytes, plan)
                  for _ in range(made.segments)]


def segment(made, i: int, rng: np.random.Generator) -> bytes:
    c, segment_bytes = made.c, made.segment_bytes
    plan = made.plans[i]
    parts = [plan[j] for j in rng.permutation(len(plan))]
    fresh = sum(n for kind, n in parts if kind == 1)
    prose = _prose(rng, made.words, fresh, tuple(c["sentence_words"]))
    pieces, at, size = [], 0, 0
    for kind, n in parts:
        if kind == 0:
            piece = made.shared[int(rng.integers(len(made.shared)))]
        else:
            piece = prose[at:at + n]
            at += n
        pieces.append(piece)
        size += len(piece)
    while size < segment_bytes:    # the shared sections drawn ran short
        piece = _prose(rng, made.words, segment_bytes - size,
                       tuple(c["sentence_words"]))
        pieces.append(piece)
        size += len(piece)
    return np.concatenate(pieces)[:segment_bytes].tobytes()
