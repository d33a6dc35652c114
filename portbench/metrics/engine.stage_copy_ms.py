"""The median ``engine.stage_copy`` span of the traced window: a call's
copy of its segment into this thread's staging (pinned on the card) and
the slack zeroed, by the engine's own span ring."""

from portbench import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "ingest_GBps"


def read(run):
    return spans.median_ms(run, "engine.stage_copy")
