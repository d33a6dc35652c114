"""The median ``index.near_stack`` span of the traced window: the LSH
index's signature matrix built again from its rows (``np.stack``) by a
query after an add, by the sidecar's own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "index"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "index.near_stack")
