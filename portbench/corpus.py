"""The pool of segments a cell's streams send, made from the seed.

One general generator for every configuration: the configuration's file
names a corpus ``kind`` and its make-up, and this module builds the pool
of distinct full segments from it, vectorised; each segment can be made
on its own, so that set-up makes them in parallel processes.

Every seed gets the same work in another order.  The plan of each
segment (how many parts of each kind, and their sizes) comes from the
corpus's fixed ``plan_seed``; the run's seed shuffles the parts of every
segment and draws their bytes: the words of fresh prose, which shared
section or block recurs where, the random payloads.  So the bytes differ
from seed to seed and the sizes and the share of each kind do not.

Two kinds, each the make-up of a corpus of ``bench_configs.py``:

- ``text``: web-text-like prose (``bench_configs._text_corpus``): words
  ``w0`` .. ``w<vocabulary-1>`` in sentences of 6-18 words, each word
  followed by a space and each sentence's last by ". "; a part is one of
  the shared sections with odds ``shared_odds``, else a run of fresh
  prose.  A fresh run is cut from a stream of whole sentences, so it may
  start mid-sentence (the reference starts each run on a sentence).
- ``binaries``: mixed binaries (``bench_configs._mixed_binaries``): one
  of the shared random blocks, a run of zeros, or a fresh random block,
  drawn with the odds given.
"""

from __future__ import annotations

import numpy as np

# The widest token of the text kind: "w" + 4 digits + ". ".
_TOKEN_WIDTH = 7


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [k % (1 << 64) for k in key]))


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


def _text_plan(c: dict, segment_bytes: int, plan: np.random.Generator
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


def _text_segment(c: dict, segment_bytes: int, plan, shared, words,
                  rng: np.random.Generator) -> bytes:
    parts = [plan[i] for i in rng.permutation(len(plan))]
    fresh = sum(n for kind, n in parts if kind == 1)
    prose = _prose(rng, words, fresh, tuple(c["sentence_words"]))
    pieces, at, size = [], 0, 0
    for kind, n in parts:
        if kind == 0:
            piece = shared[int(rng.integers(len(shared)))]
        else:
            piece = prose[at:at + n]
            at += n
        pieces.append(piece)
        size += len(piece)
    while size < segment_bytes:    # the shared sections drawn ran short
        piece = _prose(rng, words, segment_bytes - size,
                       tuple(c["sentence_words"]))
        pieces.append(piece)
        size += len(piece)
    return np.concatenate(pieces)[:segment_bytes].tobytes()


def _binary_plan(c: dict, segment_bytes: int, plan: np.random.Generator
                 ) -> list[int]:
    """Part kinds of one segment: 0 shared block, 1 zeros, 2 random."""
    sizes = (c["shared_block_bytes"], c["zero_bytes"], c["random_bytes"])
    odds = np.asarray(c["odds"], dtype=np.float64)
    parts, size = [], 0
    while size < segment_bytes:
        kind = int(plan.choice(3, p=odds / odds.sum()))
        parts.append(kind)
        size += sizes[kind]
    return parts


def _binary_segment(c: dict, segment_bytes: int, plan, shared,
                    rng: np.random.Generator) -> bytes:
    pieces, size = [], 0
    for i in rng.permutation(len(plan)):
        kind = plan[i]
        if kind == 0:
            piece = shared[int(rng.integers(len(shared)))]
        elif kind == 1:
            piece = np.zeros(c["zero_bytes"], dtype=np.uint8)
        else:
            piece = np.frombuffer(rng.bytes(c["random_bytes"]),
                                  dtype=np.uint8)
        pieces.append(piece)
        size += len(piece)
    return np.concatenate(pieces)[:segment_bytes].tobytes()


class Corpus:
    """The shared parts and the plan of a pool: the same in every process
    that builds from the same arguments, so that each segment can be made
    on its own."""

    def __init__(self, corpus: dict, segment_bytes: int, segments: int,
                 seed: int):
        self.c = corpus
        self.segment_bytes = segment_bytes
        self.seed = seed
        plan_rng = _rng(corpus["plan_seed"])
        shared_rng = _rng(seed, 1)
        kind = corpus["kind"]
        if kind == "text":
            self.words = _Words(corpus["vocabulary"])
            lo, hi = corpus["shared_bytes"]
            self.shared = [
                _prose(shared_rng, self.words,
                       int(shared_rng.integers(lo, hi + 1)),
                       tuple(corpus["sentence_words"]))
                for _ in range(corpus["shared_sections"])]
            self.plans = [_text_plan(corpus, segment_bytes, plan_rng)
                          for _ in range(segments)]
        elif kind == "binaries":
            self.shared = [
                np.frombuffer(shared_rng.bytes(corpus["shared_block_bytes"]),
                              dtype=np.uint8)
                for _ in range(corpus["shared_blocks"])]
            self.plans = [_binary_plan(corpus, segment_bytes, plan_rng)
                          for _ in range(segments)]
        else:
            raise ValueError(f"unknown corpus kind {kind!r}")

    def segment(self, i: int) -> bytes:
        rng = _rng(self.seed, 2, i)
        if self.c["kind"] == "text":
            return _text_segment(self.c, self.segment_bytes, self.plans[i],
                                 self.shared, self.words, rng)
        return _binary_segment(self.c, self.segment_bytes, self.plans[i],
                               self.shared, rng)

