"""The share of the traced window in which no kernel, copy or memset
runs on the card."""

UNIT = "%"
LAYER = "device"
MOVES = "ingest_GBps"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
