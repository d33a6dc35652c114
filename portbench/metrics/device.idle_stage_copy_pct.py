"""The share of the traced window's device idle time (as
``device.idle_pct`` counts it) during which at least one thread was
inside ``engine.stage_copy``.  Threads overlap, so this and
``device.idle_copy_back_pct`` may sum past 100.  Nothing to read where
the copy backs show the device operations off the ring's clock
(``spans.aligned``)."""

from portbench import spans

UNIT = "%"
LAYER = "device"
MOVES = "ingest_GBps"


def read(run):
    got = spans.aligned(run)
    if got is None:
        return None
    window = got[0]
    return window.idle_share(*window.intervals("engine.stage_copy"))
