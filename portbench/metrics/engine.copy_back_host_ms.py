"""The median time from the end of a call's own device-to-host copy on
the card (the last ``Memcpy DtoH`` of the trace that ends inside its
``engine.copy_back`` span) to the end of that span: the host's side of
the copy back, after the card has finished it.  Spans with no such copy
are left out; where fewer than half have one (the profiler drops
events), or where a copy starts before its span (the device operations
off the ring's clock, ``spans.aligned``), there is nothing to read."""

import numpy as np

from portbench import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    got = spans.aligned(run)
    if got is None:
        return None
    _, end, own_end = got
    return float(np.median(end - own_end)) / 1e6
