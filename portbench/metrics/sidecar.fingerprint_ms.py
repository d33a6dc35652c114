"""The median ``sidecar.fingerprint`` span of the traced window: a 125
request: its body parsed, the engine's call, the wait for the sidecar's
lock, the session's update and the per-chunk response, by the sidecar's
own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "sidecar"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "sidecar.fingerprint")
