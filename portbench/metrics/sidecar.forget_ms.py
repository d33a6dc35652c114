"""The median ``sidecar.forget`` span of the traced window: forget: the
wait for the lock, the LSH tombstones and the exact index's carrier
mask, by the sidecar's own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "sidecar"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "sidecar.forget")
