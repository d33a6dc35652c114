"""What recording a fingerprint call's spans costs the host.

    python -m fastdfs_tpu_torch.tools.span_cost

Records ``CALLS`` calls into a fresh ring of ``trace.RING_CAPACITY``
slots, each as ``DedupEngine.fingerprint`` writes one on one card (a
root and eight children: ``open``, seven ``end`` and ``close``), so
that the ring wraps once the calls pass about 116,000;
then times the same loop with only the clock reads.  Prints one JSON
line: microseconds a call with the ring, with the clock reads alone, and
the difference, for the first half of the calls (the ring filling) and
the second (the ring overwriting).  Host only; no card is touched.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

from fastdfs_tpu_torch.trace import RING_CAPACITY, CallSpans, SpanRing

CHILDREN = 8
CALLS = 200_000


def recorded_us(rec: CallSpans, codes: list[int], calls: int) -> float:
    t = time.perf_counter()
    for _ in range(calls):
        rec.open()
        for c in codes[:-1]:
            rec.end(c)
        rec.close(codes[-1])
    return (time.perf_counter() - t) / calls * 1e6


def clock_only_us(calls: int) -> float:
    clock = time.time_ns
    t = time.perf_counter()
    for _ in range(calls):
        clock()
        for _ in range(CHILDREN):
            clock()
    return (time.perf_counter() - t) / calls * 1e6


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    ring = SpanRing(RING_CAPACITY)
    rec = CallSpans(ring, "engine.fingerprint")
    codes = [ring.code(f"engine.stage{j}") for j in range(CHILDREN)]
    half = CALLS // 2
    filling = recorded_us(rec, codes, half)
    overwriting = recorded_us(rec, codes, CALLS - half)
    clock = clock_only_us(half)
    print(json.dumps({
        "calls": CALLS, "spans_a_call": CHILDREN + 1,
        "recorded": ring.recorded, "dropped": ring.dropped,
        "us_a_call_filling": filling, "us_a_call_overwriting": overwriting,
        "us_a_call_clock_reads_only": clock,
        "us_a_call_ring_over_clock": max(filling, overwriting) - clock,
        "host": platform.processor() or platform.machine(),
        "python": platform.python_version()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
