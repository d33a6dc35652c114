"""The comparison that decides a run's ``correct``.

Every call of the window is held to its rows: the cell's call says what
rows an answer has (``rows``) and what rows each item's answer must have
(``expected_rows``), and a call whose rows differ counts under the call's
``ROWS_WRONG``.  A sample of its calls, drawn from the seed, is held
whole to the plain reference (the call's ``reference``), by the call's
``compare``.  The first call of each item in the window is always in
the sample, so that every item the window sends is compared.

Every cell also counts the calls that raised or never returned
(``calls_failed``) and the items sent but never compared whole
(``segments_unchecked``).  Each number compared has its limit: these
two's here, the call's own in its ``LIMITS``.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import numpy as np

LIMITS = {
    "calls_failed": 0,          # calls that raised or never returned
    "segments_unchecked": 0,    # items sent but never compared whole
}


@dataclass
class Kept:
    """One call's answer, kept for the comparison."""
    segment: int
    answer: object


def rows_wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Rows of ``want`` that ``got`` does not hold, position by position;
    a missing or extra row counts as one."""
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    n = min(len(got), len(want))
    if got.shape[1:] != want.shape[1:]:
        return max(len(got), len(want))
    return int((got[:n] != want[:n]).any(axis=1).sum()) + abs(
        len(got) - len(want))


def limits(call: ModuleType) -> dict[str, int]:
    """Every number a cell with ``call`` compares, with its limit, in the
    order the check prints them."""
    own = dict(call.LIMITS)
    return {"calls_failed": LIMITS["calls_failed"],
            call.ROWS_WRONG: own.pop(call.ROWS_WRONG),
            "segments_unchecked": LIMITS["segments_unchecked"], **own}


def compare(call: ModuleType, kept: list[Kept],
            counts: list[tuple[int, tuple]], expected: list[tuple],
            answers: dict, failed_calls: int, segments_sent: set[int]
            ) -> dict[str, int]:
    """The numbers compared, in ``limits``' order: ``counts`` holds (item,
    ``call.rows`` of its answer) for every call that returned,
    ``expected`` each item's ``call.expected_rows``, and ``answers`` maps
    an item to its ``call.reference``."""
    checked = {k.segment for k in kept}
    numbers = {
        "calls_failed": failed_calls,
        call.ROWS_WRONG: sum(1 for s, rows in counts if rows != expected[s]),
        "segments_unchecked": len(segments_sent - checked),
        **call.compare(kept, answers),
    }
    want = limits(call)
    if numbers.keys() != want.keys():
        raise ValueError(f"the call compares {sorted(numbers)}, its limits "
                         f"name {sorted(want)}")
    return {k: numbers[k] for k in want}


def holds(numbers: dict[str, int], limits: dict[str, int]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def lines(numbers: dict[str, int], limits: dict[str, int]) -> list[str]:
    return [f"check {k} {numbers[k]} limit {limits[k]}" for k in limits]


def as_json(numbers: dict[str, int], limits: dict[str, int]) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
