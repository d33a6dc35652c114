"""The share of the traced window's device idle time (as
``device.idle_pct`` counts it) during which at least one thread was
inside ``engine.copy_back`` after its own device-to-host copy had ended
on the card (as ``engine.copy_back_host_ms`` matches them).  Threads
overlap, so this and ``device.idle_stage_copy_pct`` may sum past 100."""

from portbench import spans

UNIT = "%"
LAYER = "device"
MOVES = "ingest_GBps"


def read(run):
    got = spans.aligned(run)
    if got is None:
        return None
    window, end, own_end = got
    return window.idle_share(own_end, end)
