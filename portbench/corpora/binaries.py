"""The ``binaries`` corpus: mixed binaries (``bench_configs._mixed_binaries``).

A part is one of the shared random blocks, a run of zeros, or a fresh
random block, drawn with the odds given.  Every segment is full.
"""

from __future__ import annotations

import numpy as np


def _plan(c: dict, segment_bytes: int, plan: np.random.Generator
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


def setup(made, plan: np.random.Generator, shared: np.random.Generator
          ) -> None:
    c = made.c
    made.shared = [
        np.frombuffer(shared.bytes(c["shared_block_bytes"]), dtype=np.uint8)
        for _ in range(c["shared_blocks"])]
    made.plans = [_plan(c, made.segment_bytes, plan)
                  for _ in range(made.segments)]


def segment(made, i: int, rng: np.random.Generator) -> bytes:
    c, plan = made.c, made.plans[i]
    pieces = []
    for j in rng.permutation(len(plan)):
        kind = plan[j]
        if kind == 0:
            piece = made.shared[int(rng.integers(len(made.shared)))]
        elif kind == 1:
            piece = np.zeros(c["zero_bytes"], dtype=np.uint8)
        else:
            piece = np.frombuffer(rng.bytes(c["random_bytes"]),
                                  dtype=np.uint8)
        pieces.append(piece)
    return np.concatenate(pieces)[:made.segment_bytes].tobytes()
