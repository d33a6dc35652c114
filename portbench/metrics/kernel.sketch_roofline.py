"""The fused sketch kernel's share of its roofline: the least time the
card needs for the window's chunks (``roofline.sketch_seconds``: bytes
at the HBM rate, or 6 operations a window position and 2 a non-empty
segment minimum and permutation, the minima counted by the reference, at
the INT32 rate), over the device time of ``sketch_ragged_kernel``."""

from portbench import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "ingest_GBps"
KERNEL = "sketch_ragged_kernel"


def read(run):
    if run.trace is None or run.peak is None or not len(run.segment):
        return None
    n, seconds = run.trace.ops(KERNEL)
    if not n or seconds <= 0:
        return None
    per = {s: roofline.sketch_seconds(
        run.pool[s].lens, run.answers[s].survivors, run.dedup["num_perms"],
        run.dedup["shingle"], run.peak) for s in set(run.segment.tolist())}
    mean = sum(per[s] for s in run.segment.tolist()) / len(run.segment)
    return 100.0 * mean * min(n, len(run.segment)) / seconds
