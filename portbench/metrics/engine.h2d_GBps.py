"""The engine's uploads: the bytes it sends the card a call (the segment
and its chunk table: 16 bytes a chunk), over the device time of the
trace's host-to-device copies.  Each call makes two such copies; where
the profiler dropped some, the bytes are scaled by the share it kept."""

UNIT = "GB/s"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    if run.trace is None or not len(run.segment):
        return None
    n, seconds = run.trace.ops("HtoD")
    if not n or seconds <= 0:
        return None
    sent = sum(len(run.pool[s].data) + 16 * len(run.pool[s].cuts)
               for s in run.segment.tolist())
    return sent * min(1.0, n / (2 * len(run.segment))) / seconds / 1e9
