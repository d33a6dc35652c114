"""The 95th percentile of the window's calls of
``DedupEngine.fingerprint``, from each call to the return of its spans,
digests and signatures: how long a daemon's dio thread waits on a
segment at the tail.  In a closed loop of a fixed number of streams the
calls' time is what sets ``ingest_GBps``."""

import numpy as np

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    if not len(run.latency_s):
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
