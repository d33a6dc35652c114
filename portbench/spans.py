"""The engine's own spans in a ``--trace 1`` run, beside the device trace.

``DedupEngine.fingerprint`` writes the stages of every call into the
program's span ring (``fastdfs_tpu_torch.trace.SPAN_RING``) on the clock
of ``time.time_ns()``, which is the clock of the profiler's host events
and of the device operations it aligns to them.  The readers of
``metrics/`` keep the spans inside the traced window and lay them over
the window's device operations (``run.trace.device``):

- ``durations_ms(name)``: each span's own duration;
- ``copy_backs()``: each ``engine.copy_back`` span with the call's own
  device-to-host copy, the last ``DtoH`` operation that ends inside it;
- ``idle_share(starts, ends)``: the share of the window's device idle
  time (the window less the union of its device operations, as
  ``device.idle_pct`` counts it) that the union of the intervals covers.

``window_spans(run)`` is None where there is no trace, where the trace
holds no device operation (a run without a card: the metrics read the
engine's card path), where the program keeps no span ring (a checkout
older than it), and where the ring overwrote a span that ended inside
the window.  ``aligned(run)`` is None besides where a copy-back span's
own copy shows that the profiler placed the device operations off the
ring's clock: the readers that lay spans over device operations read
nothing there.
"""

from __future__ import annotations

import numpy as np

DTOH = "DtoH"
# How far a call's own copy may start before its copy-back span: the
# clocks' agreement where the profiler aligns them well.
CLOCK_SLACK_NS = 20_000


def merge(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals ``[starts[i], ends[i])`` as sorted,
    disjoint intervals."""
    s = np.asarray(starts, np.int64)
    e = np.asarray(ends, np.int64)
    if not len(s):
        return s, e
    o = np.argsort(s, kind="stable")
    s, e = s[o], e[o]
    reach = np.maximum.accumulate(e)
    new = np.r_[True, s[1:] > reach[:-1]]
    first = np.flatnonzero(new)
    return s[new], np.maximum.reduceat(e, first)


def overlap(s1, e1, s2, e2) -> int:
    """The length two sets of disjoint sorted intervals share."""
    if not len(s1) or not len(s2):
        return 0
    cum = np.r_[0, np.cumsum(e2 - s2)]

    def upto(t):
        i = np.searchsorted(s2, t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.where(i > 0, np.clip(t - s2[j], 0, e2[j] - s2[j]), 0)
        return cum[j] + part

    return int((upto(e1) - upto(s1)).sum())


class WindowSpans:
    def __init__(self, arrays: dict, names: list[str], trace) -> None:
        self.a = arrays
        self.names = names
        self.trace = trace

    def of(self, name: str) -> np.ndarray:
        if name not in self.names:
            return np.zeros(len(self.a["name"]), bool)
        return self.a["name"] == self.names.index(name)

    def durations_ms(self, name: str) -> np.ndarray:
        m = self.of(name)
        return (self.a["end_ns"][m] - self.a["start_ns"][m]) / 1e6

    def intervals(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        m = self.of(name)
        return self.a["start_ns"][m], self.a["end_ns"][m]

    def copy_backs(self) -> tuple[np.ndarray, ...]:
        """Every ``engine.copy_back`` span's start and end, the start and
        end of its call's own ``DtoH`` copy (the last to end inside the
        span), and whether it has one."""
        s, e = self.intervals("engine.copy_back")
        copies = sorted((b, a) for n, a, b in self.trace.device if DTOH in n)
        de = np.array([b for b, _ in copies], np.int64)
        ds = np.array([a for _, a in copies], np.int64)
        j = np.searchsorted(de, e, side="right") - 1
        hit = j >= 0
        hit[hit] = de[j[hit]] >= s[hit]
        k = np.maximum(j, 0)
        own_end = np.where(hit, de[k] if len(de) else 0, 0)
        own_start = np.where(hit, ds[k] if len(ds) else 0, 0)
        return s, e, own_start, own_end, hit

    def busy(self) -> tuple[np.ndarray, np.ndarray]:
        dev = self.trace.device
        return merge([a for _, a, _ in dev], [b for _, _, b in dev])

    def idle_share(self, starts, ends) -> float | None:
        """The share, in %, of the window's device idle time that the
        intervals cover."""
        w0, w1 = self.trace.window
        bs, be = self.busy()      # the trace clips its operations to the window
        idle = (w1 - w0) - int((be - bs).sum())
        if idle <= 0:
            return None
        us, ue = merge(np.clip(starts, w0, w1), np.clip(ends, w0, w1))
        inside = int((ue - us).sum()) - overlap(us, ue, bs, be)
        return 100.0 * inside / idle


def window_spans(run) -> WindowSpans | None:
    if run.trace is None or not run.trace.device:
        return None
    try:
        from fastdfs_tpu_torch import trace as program_trace
        ring = program_trace.SPAN_RING
    except (ImportError, AttributeError):
        return None
    w0, w1 = run.trace.window
    if ring.lost_until_ns > w0:
        return None
    arrays = ring.arrays(w0, w1)
    if not len(arrays["seq"]):
        return None
    return WindowSpans(arrays, list(ring.names), run.trace)


def median_ms(run, name: str) -> float | None:
    spans = window_spans(run)
    if spans is None:
        return None
    d = spans.durations_ms(name)
    return float(np.median(d)) if len(d) else None


def aligned(run):
    """The window's spans, and the ends of the copy-back spans that have
    their own ``DtoH`` copy with that copy's end; or None where fewer
    than half have one (the profiler drops events), or where any such
    copy starts more than ``CLOCK_SLACK_NS`` before its span: a copy
    starts after the ``.cpu()`` that issues it, so the profiler then
    placed device time off the ring's clock, and a copy may be matched
    to the wrong call."""
    spans = window_spans(run)
    if spans is None:
        return None
    start, end, own_start, own_end, hit = spans.copy_backs()
    if not len(end) or 2 * int(hit.sum()) < len(end):
        return None
    if (own_start[hit] - start[hit]).min() < -CLOCK_SLACK_NS:
        return None
    return spans, end[hit], own_end[hit]
