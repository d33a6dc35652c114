"""The median of the window's calls of ``DedupEngine.fingerprint``, by
the benchmark's own span around each call: the engine's typical time,
beside the tail that ``engine.call_p95_ms`` reads."""

import numpy as np

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    if not len(run.latency_s):
        return None
    return float(np.median(run.latency_s)) * 1e3
