"""The pool of items a cell's streams send, made from the seed.

One loader for every configuration: the configuration's file names a
corpus ``kind`` and its make-up, and the kind's file,
``corpora/<kind>.py``, found by name (``manifest.load_corpus``), builds
the pool of distinct items from it, vectorised; each item can be made on
its own, so that set-up makes them on several threads.  A kind file
defines:

- ``setup(made, plan, shared)``: what the pool's items share, kept as
  attributes of ``made`` (this module's ``Corpus``: ``c``, the make-up;
  ``segment_bytes``; ``segments``; ``seed``), with the plan of each item
  drawn from ``plan`` and the parts items share from ``shared``;
- ``segment(made, i, rng) -> bytes``: item ``i``, its bytes drawn from
  ``rng``, at most ``segment_bytes`` long (a kind may make items shorter).

Every seed gets the same work in another order.  ``plan`` comes from the
corpus's fixed ``plan_seed``, so the plan of each item (how many parts
of each kind, and their sizes) is the same for every seed; ``shared``
and ``rng`` come from the run's seed, which shuffles each item's parts
and draws their bytes.  So the bytes differ from seed to seed and the
sizes and the share of each kind do not.
"""

from __future__ import annotations

from types import ModuleType

import numpy as np

from portbench import manifest


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [k % (1 << 64) for k in key]))


class Corpus:
    """The shared parts and the plan of a pool: the same in every process
    that builds from the same arguments, so that each item can be made on
    its own, from any thread.  ``kind`` is the kind's loaded file; by
    default the one of this checkout that ``corpus["kind"]`` names."""

    def __init__(self, corpus: dict, segment_bytes: int, segments: int,
                 seed: int, kind: ModuleType | None = None):
        self.c = corpus
        self.segment_bytes = segment_bytes
        self.segments = segments
        self.seed = seed
        self.kind = kind or manifest.load_corpus(manifest.ROOT,
                                                 corpus["kind"])
        self.kind.setup(self, _rng(corpus["plan_seed"]), _rng(seed, 1))

    def segment(self, i: int) -> bytes:
        return self.kind.segment(self, i, _rng(self.seed, 2, i))
