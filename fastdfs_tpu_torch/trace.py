"""Distributed request tracing: client-side span recording, cluster span
collection, stitching, and timeline rendering.  The port's copy of
``fastdfs_tpu/trace.py``, over the port's client.

The pipeline (fastdfs_tpu extension; upstream FastDFS has no tracing):

1. The client starts a trace (``Tracer``) and prefixes each RPC with a
   ``TRACE_CTX`` frame (``common.protocol``: a normal header with
   cmd=TRACE_CTX whose 16-byte body is trace_id + parent span_id +
   flags).  The frame elicits no response; the daemon applies it to the
   next request on the connection.
2. Each daemon records named spans (request root + stage children:
   nio recv, fingerprint, chunk-store write, binlog append; the
   replication sender adds ``sync.ship``; recovery adds
   ``recovery.*``) into a fixed-size ring buffer
   (``native/common/trace.{h,cc}``).
3. ``collect_cluster_spans`` pulls every node's ring via the
   ``TRACE_DUMP`` opcodes, ``stitch`` groups spans by trace_id, and
   ``render_timeline`` draws one request's cross-node timeline.

The port's own processes keep such a ring too: ``SPAN_RING``, one per
process, always on, into which ``DedupEngine.fingerprint`` writes the
stages of every call (``CallSpans``).  It dumps in the same shape, so
``decode_dump``, ``stitch`` and ``render_timeline`` read it unchanged.
Its timestamps come from ``time.time_ns()``: the daemons' wall clock,
and the clock of ``torch.profiler``'s host events.

The dump JSON shape is the cross-language contract (covered by the
``fdfs_codec trace-json`` golden in tests/test_trace.py):

    {"role": "storage"|"tracker", "port": N,
     "spans": [{"trace_id": "16-hex", "span_id": "8-hex",
                "parent_id": "8-hex", "name": str, "start_us": int,
                "dur_us": int, "status": int, "flags": int}]}
"""

from __future__ import annotations

import array
import json
import secrets
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from fastdfs_tpu_torch.common.protocol import (
    TRACE_CTX_LEN,
    TRACE_FLAG_SAMPLED,
    TRACE_FLAG_SLOW,
    StorageCmd,
    pack_header,
    pack_trace_ctx,
    unpack_trace_ctx,
)

__all__ = [
    "TraceContext", "Span", "Tracer", "decode_dump", "stitch",
    "render_timeline", "collect_cluster_spans", "traced_upload",
    "TRACE_FLAG_SAMPLED", "TRACE_FLAG_SLOW", "SpanRing", "CallSpans",
    "SPAN_RING", "RING_CAPACITY",
]


# ---------------------------------------------------------------------------
# context + wire frame
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceContext:
    """What rides the TRACE_CTX prefix frame: the trace plus the span the
    receiver's work should nest under."""

    trace_id: int
    span_id: int
    flags: int = TRACE_FLAG_SAMPLED

    def frame(self) -> bytes:
        """The full prefix frame: header(cmd=TRACE_CTX, len=16) + body.
        TrackerCmd.TRACE_CTX == StorageCmd.TRACE_CTX, so one frame works
        on either port."""
        return (pack_header(TRACE_CTX_LEN, StorageCmd.TRACE_CTX)
                + pack_trace_ctx(self.trace_id, self.span_id, self.flags))

    @classmethod
    def unpack(cls, body: bytes) -> "TraceContext":
        tid, span, flags = unpack_trace_ctx(body)
        return cls(trace_id=tid, span_id=span, flags=flags)


def _new_trace_id() -> int:
    return secrets.randbits(64) or 1


def _new_span_id() -> int:
    # High bit clear: daemon-allocated span ids set it, so client and
    # daemon ids never collide even without coordination.
    return secrets.randbits(31) or 1


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_id: int
    name: str
    start_us: int
    dur_us: int
    status: int = 0
    flags: int = 0
    node: str = ""       # "role addr" of the daemon (or "client")

    @property
    def end_us(self) -> int:
        return self.start_us + self.dur_us


def decode_dump(obj: dict, node: str = "") -> list[Span]:
    """Validate and decode one daemon's TRACE_DUMP JSON into Spans.

    Raises ValueError on shape violations so a truncated or foreign
    payload fails loudly (same discipline as monitor.decode_registry).
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("spans"), list):
        raise ValueError(f"trace dump must have a spans list: {obj!r}")
    role = obj.get("role", "")
    if node == "":
        node = f"{role}:{obj.get('port', '')}"
    out: list[Span] = []
    for s in obj["spans"]:
        try:
            out.append(Span(
                trace_id=int(s["trace_id"], 16),
                span_id=int(s["span_id"], 16),
                parent_id=int(s["parent_id"], 16),
                name=str(s["name"]),
                start_us=int(s["start_us"]),
                dur_us=int(s["dur_us"]),
                status=int(s.get("status", 0)),
                flags=int(s.get("flags", 0)),
                node=node,
            ))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed span {s!r}: {e}") from None
    return out


# ---------------------------------------------------------------------------
# client-side tracer
# ---------------------------------------------------------------------------

class Tracer:
    """One trace: client spans recorded locally, wire context derived
    from the innermost open span.  Install on an ``FdfsClient`` (its
    connection plumbing consults ``wire_ctx()``) or use the module-level
    helpers like ``traced_upload``."""

    def __init__(self, flags: int = TRACE_FLAG_SAMPLED):
        self.trace_id = _new_trace_id()
        self.flags = flags
        self.spans: list[Span] = []
        self._stack: list[int] = []

    @contextmanager
    def span(self, name: str):
        """Record a client span; nested spans parent to the enclosing
        one, and RPCs issued inside parent to the innermost span."""
        sid = _new_span_id()
        parent = self._stack[-1] if self._stack else 0
        self._stack.append(sid)
        start = int(time.time() * 1e6)
        try:
            yield TraceContext(self.trace_id, sid, self.flags)
        finally:
            self._stack.pop()
            self.spans.append(Span(
                trace_id=self.trace_id, span_id=sid, parent_id=parent,
                name=name, start_us=start,
                dur_us=int(time.time() * 1e6) - start, node="client"))

    def wire_ctx(self) -> TraceContext | None:
        """Context for the next outgoing RPC (None outside any span)."""
        if not self._stack:
            return None
        return TraceContext(self.trace_id, self._stack[-1], self.flags)


def traced_upload(client, data: bytes, ext: str = "",
                  group: str | None = None) -> tuple[str, Tracer]:
    """Upload ``data`` under a fresh trace; returns (file_id, tracer).
    The tracker query and the storage upload both carry the context, so
    their daemon spans stitch under the client.upload span."""
    tracer = Tracer()
    prev = getattr(client, "tracer", None)
    client.tracer = tracer
    try:
        with tracer.span("client.upload"):
            fid = client.upload_buffer(data, ext=ext, group=group)
    finally:
        client.tracer = prev
    return fid, tracer


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def collect_cluster_spans(client) -> tuple[list[Span], dict[str, str]]:
    """Pull every node's span ring through an ``FdfsClient``: each
    configured tracker plus every storage the tracker knows.  Returns
    (spans, errors-by-node); dead nodes land in errors, collection is
    best-effort like monitor.gather."""
    from fastdfs_tpu_torch.client.storage_client import StorageClient
    from fastdfs_tpu_torch.client.tracker_client import TrackerClient

    spans: list[Span] = []
    errors: dict[str, str] = {}
    storages: list[tuple[str, int]] = []
    for host, port in client.trackers:
        addr = f"{host}:{port}"
        try:
            with TrackerClient(host, port, client.timeout) as tc:
                spans.extend(decode_dump(tc.trace_dump(), f"tracker {addr}"))
                for g in tc.cluster_stat().get("groups", []):
                    for s in g.get("storages", []):
                        storages.append((s["ip"], s["port"]))
        except Exception as e:  # noqa: BLE001 — record, keep going
            errors[addr] = f"{type(e).__name__}: {e}"
    for ip, port in sorted(set(storages)):
        addr = f"{ip}:{port}"
        try:
            with StorageClient(ip, port, client.timeout,
                               device=client.device) as sc:
                spans.extend(decode_dump(sc.trace_dump(), f"storage {addr}"))
        except Exception as e:  # noqa: BLE001
            errors[addr] = f"{type(e).__name__}: {e}"
    return spans, errors


# ---------------------------------------------------------------------------
# stitching + rendering
# ---------------------------------------------------------------------------

def _stitch_with_depths(spans: list[Span]) -> dict[int, list[tuple[Span, int]]]:
    """Group spans by trace_id; within a trace, parents sort before
    children (tree order, each paired with its nesting depth), ties
    broken by start time.  Orphans (parent span not collected — e.g.
    overwritten in a ring) sort by start time at top level, so a
    partial trace still renders."""
    by_trace: dict[int, list[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)

    def order(trace: list[Span]) -> list[tuple[Span, int]]:
        ids = {s.span_id for s in trace}
        children: dict[int, list[Span]] = {}
        roots: list[Span] = []
        for s in sorted(trace, key=lambda x: (x.start_us, x.span_id)):
            if s.parent_id and s.parent_id in ids and s.parent_id != s.span_id:
                children.setdefault(s.parent_id, []).append(s)
            else:
                roots.append(s)
        out: list[tuple[Span, int]] = []
        seen: set[int] = set()

        def walk(s: Span, depth: int):
            # Cycle/defense guard: colliding span ids (e.g. two daemons'
            # rings allocating the same id) must degrade the rendering,
            # never hang it.
            if id(s) in seen or depth > 64:
                return
            seen.add(id(s))
            out.append((s, depth))
            for c in children.get(s.span_id, []):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 0)
        # Anything unreachable through the tree (cycle members) still
        # shows up, flat, at the end.
        for s in trace:
            if id(s) not in seen:
                seen.add(id(s))
                out.append((s, 0))
        return out

    return {tid: order(tr) for tid, tr in by_trace.items()}


def stitch(spans: list[Span]) -> dict[int, list[Span]]:
    """Tree-ordered spans per trace_id (see _stitch_with_depths, which
    the renderer uses to also get nesting depths)."""
    return {tid: [s for s, _ in pairs]
            for tid, pairs in _stitch_with_depths(spans).items()}


def render_timeline(spans: list[Span], trace_id: int | None = None) -> str:
    """Human timeline: one trace per block, one line per span with its
    node, name, offset from trace start, duration, and a scaled bar."""
    stitched = _stitch_with_depths(spans)
    if trace_id is not None:
        stitched = {trace_id: stitched.get(trace_id, [])}
    lines: list[str] = []
    for tid, trace in sorted(stitched.items()):
        if not trace:
            lines.append(f"trace {tid:016x}: no spans collected")
            continue
        t0 = min(s.start_us for s, _ in trace)
        t1 = max(s.end_us for s, _ in trace)
        total = max(t1 - t0, 1)
        nodes = sorted({s.node for s, _ in trace})
        lines.append(f"trace {tid:016x}  spans={len(trace)} "
                     f"nodes={len(nodes)} total={total / 1000:.2f}ms")
        width = 24
        for s, depth in trace:
            off = s.start_us - t0
            lo = min(int(off * width / total), width - 1)
            hi = min(max(int((off + s.dur_us) * width / total), lo + 1), width)
            bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
            flagtxt = " SLOW" if s.flags & TRACE_FLAG_SLOW else ""
            err = f" status={s.status}" if s.status else ""
            lines.append(
                f"  [{s.node:<22}] {'  ' * depth}{s.name:<28} "
                f"|{bar}| +{off / 1000:.2f}ms {s.dur_us / 1000:.2f}ms"
                f"{err}{flagtxt}")
    return "\n".join(lines)


def spans_to_json(spans: list[Span]) -> str:
    """Machine form of a collected span set (``cli.py trace --json``)."""
    return json.dumps([{
        "trace_id": f"{s.trace_id:016x}",
        "span_id": f"{s.span_id:08x}",
        "parent_id": f"{s.parent_id:08x}",
        "name": s.name,
        "start_us": s.start_us,
        "dur_us": s.dur_us,
        "status": s.status,
        "flags": s.flags,
        "node": s.node,
    } for s in spans], indent=2)


# ---------------------------------------------------------------------------
# the in-process span ring
# ---------------------------------------------------------------------------

RING_CAPACITY = 1 << 20
# Span ids of the ring: 31 bits, never 0 (0 is "no parent").
_SPAN_ID_MOD = (1 << 31) - 1
# The most spans one call may write.
_MAX_CALL_SPANS = 1 << 12
# A call's spans are written children first, root last: each span's
# distance to its root, for a call of k spans, is _TO_ROOT[-k:].
_TO_ROOT = array.array("h", range(_MAX_CALL_SPANS - 1, -1, -1))
# The slots' columns and their types, as ``array`` typecodes (int64,
# int16, int32), which NumPy reads too.
_COLUMNS = {"start": "q", "end": "q", "name": "h", "tid": "i", "to_root": "h"}


class SpanRing:
    """The Python counterpart of the daemons' ``TraceRing``: a fixed
    number of span slots, the oldest overwritten, with ``recorded`` and
    ``dropped`` counted as the native ring counts them.

    Spans arrive a call at a time (``CallSpans``): the children that
    follow one another inside the call, then its root.  The slots are
    columns allocated on the first record: start and end
    (``time.time_ns()``), name code, native thread id, and each span's
    distance to its root (0 for the root), from which its parent and its
    call follow.  A call's id, the trace id of its spans, is its root's
    place in the order of recording plus one.
    """

    def __init__(self, capacity: int = RING_CAPACITY) -> None:
        self.capacity = capacity
        self.recorded = 0
        # The latest end of any span the ring has overwritten: a window
        # that starts after it lost nothing.
        self.lost_until_ns = 0
        self.names: list[str] = []
        self._codes: dict[str, int] = {}
        self._lock = threading.Lock()
        self._cols: dict[str, np.ndarray] = {}
        self._views: tuple = ()

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    def code(self, name: str) -> int:
        """The name's code in this ring, registered on first use."""
        with self._lock:
            if name not in self._codes:
                self._codes[name] = len(self.names)
                self.names.append(name)
            return self._codes[name]

    def _allocate(self) -> None:
        # Zeros, so that a slot never written ends at 0; the pages are
        # touched only as spans arrive.
        self._cols = {key: np.zeros(self.capacity, code)
                      for key, code in _COLUMNS.items()}
        # Typed views of the columns, written as ``array.array``s are.
        self._views = tuple(memoryview(self._cols[key]).cast("B").cast(code)
                            for key, code in _COLUMNS.items())

    def _record(self, start: array.array, end: array.array,
                name: array.array, tids: array.array) -> None:
        """One call's spans as columns, its children in order and then its
        root: starts, ends, name codes, and ``tids`` the thread's id, at
        least once a span."""
        k = len(name)
        if not 0 < k <= _MAX_CALL_SPANS or len(start) != k or len(end) != k:
            raise ValueError(f"a call writes 1 to {_MAX_CALL_SPANS} spans, "
                             f"each with a start and an end, not {k} names, "
                             f"{len(start)} starts and {len(end)} ends")
        rows = (start, end, name, tids[:k], _TO_ROOT[-k:])
        with self._lock:
            if not self._views:
                self._allocate()
            cap = self.capacity
            i = self.recorded % cap
            # The call's slots: from i to the end of the ring, the rest
            # from slot 0.
            j = min(k, cap - i)
            ends = self._views[1]
            if self.recorded + k > cap:
                # The slots about to be overwritten (one never written
                # ends at 0).
                self.lost_until_ns = max(self.lost_until_ns, *ends[i:i + j],
                                         *ends[:k - j])
            self.recorded += k
            for view, row in zip(self._views, rows):
                if j < k:
                    view[:k - j] = row[j:]
                    row = row[:j]
                view[i:i + j] = row

    def arrays(self, since_ns: int | None = None,
               until_ns: int | None = None) -> dict[str, np.ndarray]:
        """The kept spans that start at or after ``since_ns`` and end by
        ``until_ns``, in the order of recording, as arrays: ``seq`` (the
        place in that order), ``start_ns``, ``end_ns``, ``name`` (codes
        into ``names``), ``call``, ``tid`` and ``parent_seq`` (-1 for a
        root).  A child whose root was overwritten keeps its call id and
        names a parent that is gone."""
        with self._lock:
            n = min(self.recorded, self.capacity)
            head = self.recorded % self.capacity
            order = (np.r_[head:self.capacity, 0:head]
                     if self.recorded > self.capacity else np.arange(n))
            out = ({key: col[order] for key, col in self._cols.items()}
                   if n else {key: np.zeros(0, code)
                              for key, code in _COLUMNS.items()})
            first = self.recorded - n
        out["seq"] = first + np.arange(n, dtype=np.int64)
        to_root = out.pop("to_root").astype(np.int64)
        out["parent_seq"] = np.where(to_root > 0, out["seq"] + to_root, -1)
        out["call"] = out["seq"] + to_root + 1
        out["start_ns"] = out.pop("start")
        out["end_ns"] = out.pop("end")
        keep = np.ones(n, bool)
        if since_ns is not None:
            keep &= out["start_ns"] >= since_ns
        if until_ns is not None:
            keep &= out["end_ns"] <= until_ns
        return {k: v[keep] for k, v in out.items()}

    def spans(self, since_ns: int | None = None, until_ns: int | None = None,
              newest: int | None = None) -> list[Span]:
        """The kept spans inside the window as ``Span`` objects, in whole
        microseconds (an end is floored as its start is, so children
        stay inside their root), or only the ``newest`` of them."""
        a = self.arrays(since_ns, until_ns)
        if newest is not None:
            a = {k: v[max(0, len(v) - newest):] for k, v in a.items()}
        start_us = a["start_ns"] // 1000
        end_us = a["end_ns"] // 1000
        span_id = a["seq"] % _SPAN_ID_MOD + 1
        parent = np.where(a["parent_seq"] >= 0,
                          a["parent_seq"] % _SPAN_ID_MOD + 1, 0)
        return [Span(trace_id=c, span_id=s, parent_id=p, name=self.names[n],
                     start_us=b, dur_us=e - b, node="engine")
                for c, s, p, n, b, e in zip(
                    a["call"].tolist(), span_id.tolist(), parent.tolist(),
                    a["name"].tolist(), start_us.tolist(), end_us.tolist())]

    def dump(self, role: str, newest: int | None = None) -> dict:
        """A ``TRACE_DUMP`` object (what ``decode_dump`` reads) of the
        kept spans, or of the ``newest``, sorted by start as the native
        ring sorts them, with the ring's ``recorded`` and ``dropped``."""
        spans = sorted(self.spans(newest=newest),
                       key=lambda s: (s.start_us, s.span_id))
        return {"role": role, "port": 0, "recorded": self.recorded,
                "dropped": self.dropped,
                "spans": [{"trace_id": f"{s.trace_id:016x}",
                           "span_id": f"{s.span_id:08x}",
                           "parent_id": f"{s.parent_id:08x}",
                           "name": s.name, "start_us": s.start_us,
                           "dur_us": s.dur_us, "status": 0, "flags": 0}
                          for s in spans]}


class CallSpans:
    """One thread's recorder, one call at a time.  The root and its first
    child start at ``open``; each ``end(code)`` closes the child that
    began at the mark before it and starts the next; ``close(code)``
    closes the last child and the root at one mark, so the children cover
    the call from end to end.  The marks stay in this recorder until
    ``close`` writes the call to the ring in one short locked append.  A
    call that never reaches ``close`` writes nothing."""

    __slots__ = ("ring", "root", "tids", "marks", "codes")

    def __init__(self, ring: SpanRing, name: str) -> None:
        self.ring = ring
        self.root = ring.code(name)
        self.tids = array.array("i", [threading.get_native_id()]
                                ) * _MAX_CALL_SPANS
        self.marks = array.array("q")
        self.codes = array.array("h")

    def open(self) -> None:
        del self.marks[:]
        del self.codes[:]
        self.marks.append(time.time_ns())

    def end(self, code: int) -> None:
        self.marks.append(time.time_ns())
        self.codes.append(code)

    def close(self, code: int) -> None:
        self.end(code)
        marks = self.marks
        # Child j runs from marks[j] to marks[j + 1], the root from the
        # first mark to the last.
        start = marks[:]
        start[-1] = marks[0]
        end = marks[1:]
        end.append(marks[-1])
        name = self.codes[:]
        name.append(self.root)
        self.ring._record(start, end, name, self.tids)


SPAN_RING = SpanRing()
