"""The median ``engine.copy_back`` span of the traced window: a run's
``.cpu()`` of its digests and signatures, which waits on the stream the
engine's threads share, then copies device to host into fresh pageable
memory, by the engine's own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "engine.copy_back")
