"""Ingest rate: the bytes of every segment that returned in the window,
over the window's seconds (first call to last return), across all
streams.  What bounds a node's dedup ingest."""

UNIT = "GB/s"


def read(run):
    if not run.bytes_done or run.window_s <= 0:
        return None
    return run.bytes_done / run.window_s / 1e9
