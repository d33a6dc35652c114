"""The comparison that decides a run's ``correct``.

Every call of the window is held to its rows: as many spans, digests and
signatures as the cuts make chunks, the digests five 32-bit words a row
and the signatures one a permutation.  A sample of its calls, drawn from
the seed, is held whole to the plain reference
(``reference.answer``): every span, every 20-byte SHA-1 digest and every
64-permutation signature.  The first call of each segment in the window
is always in the sample, so that every segment the window sends is
compared.

Each number compared has the limit 0: the engine's answers are exact
(the SHA-1 is the chunk's content address, the signatures are the
sketch's specification), so one differing chunk is a wrong answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LIMITS = {
    "calls_failed": 0,          # calls that raised or never returned
    "chunk_counts_wrong": 0,    # calls whose rows are not the cuts' chunks
    "segments_unchecked": 0,    # segments sent but never compared whole
    "spans_wrong": 0,           # chunks of compared calls, each field
    "digests_wrong": 0,
    "sigs_wrong": 0,
}


@dataclass
class Kept:
    """One call's answer, kept for the comparison."""
    segment: int
    spans: list
    digests: np.ndarray
    sigs: np.ndarray


def _rows_wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Rows of ``want`` that ``got`` does not hold, position by position;
    a missing or extra row counts as one."""
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    n = min(len(got), len(want))
    if got.shape[1:] != want.shape[1:]:
        return max(len(got), len(want))
    return int((got[:n] != want[:n]).any(axis=1).sum()) + abs(
        len(got) - len(want))


def rows_of(spans, digests, sigs) -> tuple[int, int, int, int]:
    """What every call is held to: its spans' count, its digests' and its
    signatures' rows, and the signatures' width; -1 for an array that is
    not 32-bit words in rows (digests five words wide)."""
    def rows(a, width=None):
        a = np.asarray(a)
        if a.ndim != 2 or a.dtype.itemsize != 4 or a.dtype.kind not in "iu" \
                or (width is not None and a.shape[1] != width):
            return -1, -1
        return a.shape

    return (len(spans), rows(digests, 5)[0], *rows(sigs))


def compare(kept: list[Kept], counts: list[tuple[int, tuple]],
            expected_counts: list[int], perms: int, answers: dict,
            failed_calls: int, segments_sent: set[int]) -> dict[str, int]:
    """The numbers compared: ``counts`` holds (segment, ``rows_of`` its
    answer) for every call that returned; ``answers`` maps a segment to
    its ``reference.Answer``."""
    wrong_counts = sum(
        1 for s, rows in counts
        if rows != (expected_counts[s],) * 3 + (perms,))
    spans = digests = sigs = 0
    for k in kept:
        ans = answers[k.segment]
        got = np.asarray(k.spans, dtype=np.int64).reshape(-1, 2)
        spans += _rows_wrong(got, np.stack([ans.offsets, ans.lens], axis=1))
        digests += _rows_wrong(np.asarray(k.digests, dtype=np.uint32),
                               ans.digests)
        sigs += _rows_wrong(np.asarray(k.sigs, dtype=np.uint32), ans.sigs)
    checked = {k.segment for k in kept}
    return {
        "calls_failed": failed_calls,
        "chunk_counts_wrong": wrong_counts,
        "segments_unchecked": len(segments_sent - checked),
        "spans_wrong": spans,
        "digests_wrong": digests,
        "sigs_wrong": sigs,
    }


def holds(numbers: dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: dict[str, int]) -> list[str]:
    return [f"check {k} {numbers[k]} limit {LIMITS[k]}" for k in LIMITS]


def as_json(numbers: dict[str, int]) -> dict:
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
