"""The median ``sidecar.commit`` span of the traced window:
commitchunks' index updates: the wait for the lock, each chunk's exact
insert and the signature's LSH add, by the sidecar's own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "sidecar"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "sidecar.commit")
