"""The median ``engine.unpack`` span of the traced window: the runs'
answers concatenated, then the spans list and the contiguous digests and
signatures that ``fingerprint`` returns, by the engine's own span
ring."""

from portbench import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "engine.unpack")
