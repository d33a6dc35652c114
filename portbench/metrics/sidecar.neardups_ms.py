"""The median ``sidecar.neardups`` span of the traced window: a NEARDUPS
report: the wait for the lock, the band lookups, the signature matrix's
rebuild where an add dropped it, and the scoring, by the sidecar's own
span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "sidecar"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "sidecar.neardups")
