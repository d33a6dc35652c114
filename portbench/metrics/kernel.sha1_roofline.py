"""The SHA-1 kernel's share of its roofline: the least time the card
needs for the window's chunks (``roofline.sha1_seconds``: bytes at the
HBM rate or 613 operations a 64-byte block at the INT32 rate), over the
device time of ``sha1_ragged_kernel`` in the trace.  One launch a call;
where the profiler dropped launches, the roofline counts as many calls
as it kept, at the window's mean."""

from portbench import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "ingest_GBps"
KERNEL = "sha1_ragged_kernel"


def read(run):
    if run.trace is None or run.peak is None or not len(run.segment):
        return None
    n, seconds = run.trace.ops(KERNEL)
    if not n or seconds <= 0:
        return None
    per = {s: roofline.sha1_seconds(run.pool[s].lens, run.peak)
           for s in set(run.segment.tolist())}
    mean = sum(per[s] for s in run.segment.tolist()) / len(run.segment)
    return 100.0 * mean * min(n, len(run.segment)) / seconds
