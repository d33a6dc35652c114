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

The dump JSON shape is the cross-language contract (covered by the
``fdfs_codec trace-json`` golden in tests/test_trace.py):

    {"role": "storage"|"tracker", "port": N,
     "spans": [{"trace_id": "16-hex", "span_id": "8-hex",
                "parent_id": "8-hex", "name": str, "start_us": int,
                "dur_us": int, "status": int, "flags": int}]}
"""

from __future__ import annotations

import json
import secrets
import time
from contextlib import contextmanager
from dataclasses import dataclass

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
    "TRACE_FLAG_SAMPLED", "TRACE_FLAG_SLOW",
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
