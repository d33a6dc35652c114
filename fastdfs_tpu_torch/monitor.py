"""Cluster observability: decode the STAT feeds, render `fdfs_monitor`
output, and emit Prometheus text exposition.

The port's copy of ``fastdfs_tpu/monitor.py``, over the port's client.
Every ``StorageClient`` it opens is on the ``FdfsClient``'s ``device``,
so a missing card raises in the caller's constructor and never turns
into an error row.

Reference: ``client/fdfs_monitor.c`` renders tracker-held per-storage
stat structs; this rebuild gets the same data in one RPC
(``TrackerCmd.SERVER_CLUSTER_STAT`` — tracker role, every group's
capacity, every storage's liveness and named last-beat stat payload)
plus a per-daemon registry dump (``StorageCmd.STAT`` — per-opcode
counters and latency histograms, per-peer sync lag, dedup and recovery
accounting).  The registry JSON shape is the cross-language contract
covered by tests/test_monitor.py's golden check:

    {"counters": {name: int}, "gauges": {name: int},
     "histograms": {name: {"bounds": [...], "counts": [...],
                           "sum": int, "count": int}}}

histogram ``counts`` has ``len(bounds) + 1`` entries, NON-cumulative,
last = overflow; ``bounds`` are inclusive upper bounds.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

from fastdfs_tpu_torch.common.protocol import (BEAT_STAT_COUNT,
                                               BEAT_STAT_FIELDS,
                                               GROUP_NAME_MAX_LEN, buff2long)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def beat_stats(values: list[int]) -> dict[str, int]:
    """Name a beat stat vector (missing tail slots read 0 — the wire
    contract is append-only)."""
    vals = list(values)[:BEAT_STAT_COUNT]
    vals += [0] * (BEAT_STAT_COUNT - len(vals))
    return dict(zip(BEAT_STAT_FIELDS, vals))


def decode_registry(obj: dict) -> dict:
    """Validate and normalize a native stats-registry snapshot.

    Raises ValueError on shape violations so a truncated or foreign
    payload fails loudly instead of rendering garbage.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"registry snapshot must be an object, got {type(obj)}")
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for section in ("counters", "gauges"):
        for name, value in obj.get(section, {}).items():
            if not isinstance(value, int):
                raise ValueError(f"{section}[{name}] is not an int: {value!r}")
            out[section][name] = value
    for name, h in obj.get("histograms", {}).items():
        bounds, counts = h.get("bounds"), h.get("counts")
        if (not isinstance(bounds, list) or not isinstance(counts, list)
                or len(counts) != len(bounds) + 1
                or not all(isinstance(v, int) for v in bounds + counts)
                or not isinstance(h.get("sum"), int)
                or not isinstance(h.get("count"), int)):
            raise ValueError(f"histograms[{name}] malformed: {h!r}")
        if sum(counts) != h["count"]:
            raise ValueError(
                f"histograms[{name}]: bucket sum {sum(counts)} != count "
                f"{h['count']}")
        out["histograms"][name] = {
            "bounds": list(bounds), "counts": list(counts),
            "sum": h["sum"], "count": h["count"],
        }
    return out


@dataclass
class ClusterSnapshot:
    """Everything the monitor shows: the tracker dump plus (best-effort)
    each storage's own registry snapshot keyed by "ip:port"."""
    now: int = 0
    tracker: dict = field(default_factory=dict)
    groups: list = field(default_factory=list)
    storage_stats: dict[str, dict] = field(default_factory=dict)
    storage_errors: dict[str, str] = field(default_factory=dict)


def gather(client, with_storage_stats: bool = True,
           group: str | None = None) -> ClusterSnapshot:
    """Collect a full snapshot via an ``FdfsClient``.

    ``group`` filters server-side (the tracker's 16B group filter), so
    the per-storage STAT round-trips only touch that group's members.
    The STAT calls are best-effort: a dead storage still appears in the
    tracker section (that IS the liveness signal), with the error
    recorded instead of its registry."""
    cs = client.cluster_stat(group)
    snap = ClusterSnapshot(now=cs.get("now", 0),
                           tracker=cs.get("tracker", {}),
                           groups=cs.get("groups", []))
    if not with_storage_stats:
        return snap
    for g in snap.groups:
        for s in g.get("storages", []):
            addr = f"{s['ip']}:{s['port']}"
            try:
                snap.storage_stats[addr] = decode_registry(
                    client.storage_stat(s["ip"], s["port"]))
            except Exception as e:  # noqa: BLE001 — record, keep going
                snap.storage_errors[addr] = f"{type(e).__name__}: {e}"
    return snap


# ---------------------------------------------------------------------------
# flight-recorder decoding (EVENT_DUMP; native/common/eventlog.h)
# ---------------------------------------------------------------------------

_EVENT_SEVERITIES = ("info", "warn", "error")


@dataclass(frozen=True)
class ClusterEvent:
    """One structured flight-recorder event."""
    seq: int
    ts_us: int
    severity: str
    type: str
    key: str
    detail: str
    node: str = ""  # "role addr" of the daemon that recorded it


def decode_events(obj: dict, node: str = "") -> list[ClusterEvent]:
    """Validate and decode one daemon's EVENT_DUMP JSON.

    Raises ValueError on shape violations so a truncated or foreign
    payload fails loudly (same discipline as decode_registry).  Unknown
    extra keys on an event are ignored — the wire contract is
    append-only."""
    if not isinstance(obj, dict) or not isinstance(obj.get("events"), list):
        raise ValueError(f"event dump must have an events list: {obj!r}")
    if node == "":
        node = f"{obj.get('role', '')}:{obj.get('port', '')}"
    out: list[ClusterEvent] = []
    for e in obj["events"]:
        try:
            sev = str(e["severity"])
            if sev not in _EVENT_SEVERITIES:
                raise ValueError(f"unknown severity {sev!r}")
            out.append(ClusterEvent(
                seq=int(e["seq"]), ts_us=int(e["ts_us"]), severity=sev,
                type=str(e["type"]), key=str(e["key"]),
                detail=str(e.get("detail", "")), node=node))
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"malformed event {e!r}: {err}") from None
    return out


# ---------------------------------------------------------------------------
# metrics-history decoding (METRICS_HISTORY; native/common/metrog.h)
# ---------------------------------------------------------------------------

def decode_metrics_history(obj: dict) -> list[dict]:
    """Validate and decode one daemon's METRICS_HISTORY JSON into
    ``[{"ts_us": int, "registry": <decode_registry shape>}, ...]``
    (oldest first — the wire order).

    Each snapshot is a full absolute registry view (the journal's
    on-disk delta encoding never reaches the wire), so every snapshot
    revalidates through decode_registry and the fdfs_top histogram math
    applies between consecutive entries unchanged."""
    if not isinstance(obj, dict) or not isinstance(obj.get("snapshots"), list):
        raise ValueError(f"metrics history must have a snapshots list: "
                         f"{type(obj)}")
    out: list[dict] = []
    for s in obj["snapshots"]:
        if not isinstance(s, dict) or not isinstance(s.get("ts_us"), int):
            raise ValueError(f"malformed snapshot: {s!r}")
        out.append({"ts_us": s["ts_us"], "registry": decode_registry(s)})
    # Wire order is journal APPEND order, which is causally correct even
    # when the daemon's wall clock stepped backwards between ticks (NTP):
    # keep it, don't sort, and don't reject — one odd ts pair must not
    # cost the whole post-mortem window (report_series floors dt anyway).
    return out


# ---------------------------------------------------------------------------
# heat decoding (HEAT_TOP; native/common/heatsketch.h)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeatEntry:
    """One hot file-id from a daemon's space-saving sketch.  ``hits`` is
    an overcount bounded by ``err_bound``: the true request count lies
    in [hits - err_bound, hits]."""
    key: str
    hits: int
    err_bound: int
    bytes: int
    err: int
    ops: dict  # op name -> {"count": int, "bytes": int}


def decode_heat(obj: dict) -> list[HeatEntry]:
    """Validate and decode one daemon's HEAT_TOP JSON (entries arrive
    sorted by hits descending; unknown extra keys are ignored — the
    wire contract is append-only)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("entries"), list):
        raise ValueError(f"heat dump must have an entries list: {obj!r}")
    out: list[HeatEntry] = []
    for e in obj["entries"]:
        try:
            ops = {}
            for op, c in dict(e.get("ops", {})).items():
                ops[str(op)] = {"count": int(c["count"]),
                                "bytes": int(c["bytes"])}
            out.append(HeatEntry(
                key=str(e["key"]), hits=int(e["hits"]),
                err_bound=int(e.get("err_bound", 0)),
                bytes=int(e.get("bytes", 0)), err=int(e.get("err", 0)),
                ops=ops))
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"malformed heat entry {e!r}: {err}") from None
    if any(a.hits < b.hits for a, b in zip(out, out[1:])):
        raise ValueError("heat entries not sorted by hits descending")
    return out


# ---------------------------------------------------------------------------
# hot-map decoding (QUERY_HOT_MAP; native/common/heatwire.h).  The wire
# shape is pinned cross-language by the fdfs_codec hot-map golden.
# ---------------------------------------------------------------------------

def decode_hot_map(body: bytes) -> dict:
    """Decode a QUERY_HOT_MAP response body (the elastic-hot-replication
    map): 8B BE version + 1B full flag + 8B BE entry count +
    per entry (8B BE key_len + key + 8B BE group count + n x 16B group
    names).  ``full`` False means a delta, where an entry with zero
    groups is a tombstone (the key was demoted).  Raises ValueError on
    shape violations so a truncated payload fails loudly."""
    if len(body) < 17:
        raise ValueError(f"hot-map body too short: {len(body)}")
    version = buff2long(body, 0)
    full = body[8] != 0
    count = buff2long(body, 9)
    off = 17
    entries = []
    for _ in range(count):
        if off + 8 > len(body):
            raise ValueError("truncated hot-map entry")
        key_len = buff2long(body, off)
        off += 8
        if key_len < 0 or off + key_len + 8 > len(body):
            raise ValueError(f"bad hot-map key length {key_len}")
        key = body[off:off + key_len].decode()
        off += key_len
        ngroups = buff2long(body, off)
        off += 8
        if ngroups < 0 or ngroups > (len(body) - off) // GROUP_NAME_MAX_LEN:
            raise ValueError(f"bad hot-map group count {ngroups}")
        groups = []
        for g in range(ngroups):
            p = off + g * GROUP_NAME_MAX_LEN
            groups.append(
                body[p:p + GROUP_NAME_MAX_LEN].rstrip(b"\x00").decode())
        off += ngroups * GROUP_NAME_MAX_LEN
        entries.append({"key": key, "groups": groups})
    return {"version": version, "full": full, "entries": entries}


# ---------------------------------------------------------------------------
# profile decoding (PROFILE_DUMP; native/common/profiler.h).  The wire
# shape is pinned cross-language by the fdfs_codec profile-json golden.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProfileStack:
    """One folded stack: ``thread;outermost;...;leaf`` with how many
    SIGPROF samples landed there."""
    stack: str
    count: int

    @property
    def thread(self) -> str:
        return self.stack.split(";", 1)[0]


@dataclass(frozen=True)
class ProfileDump:
    role: str            # "storage" | "tracker"
    port: int
    active: bool         # capture still armed at dump time
    hz: int              # as armed (post profile_max_hz clamp)
    duration_s: int
    samples: int         # handler captures (kept + aggregated)
    dropped: int         # slab-overflow drops — nonzero means the
    #                      profile under-represents the busiest window
    overhead_us: int     # cumulative handler wall time
    max_frames: int      # stack truncation depth (deeper frames lost)
    stacks: tuple        # ProfileStack, count-descending


def decode_profile(obj: dict) -> ProfileDump:
    """Validate and decode one daemon's PROFILE_DUMP JSON (stacks arrive
    sorted by count descending; unknown extra keys are ignored — the
    wire contract is append-only)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("stacks"), list):
        raise ValueError(f"profile dump must have a stacks list: {obj!r}")
    rows: list[ProfileStack] = []
    for s in obj["stacks"]:
        try:
            rows.append(ProfileStack(stack=str(s["stack"]),
                                     count=int(s["count"])))
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"malformed profile stack {s!r}: {err}") from None
    if any(a.count < b.count for a, b in zip(rows, rows[1:])):
        raise ValueError("profile stacks not sorted by count descending")
    try:
        return ProfileDump(
            role=str(obj["role"]), port=int(obj["port"]),
            active=bool(obj["active"]), hz=int(obj["hz"]),
            duration_s=int(obj["duration_s"]), samples=int(obj["samples"]),
            dropped=int(obj["dropped"]),
            overhead_us=int(obj.get("overhead_us", 0)),
            max_frames=int(obj.get("max_frames", 0)),
            stacks=tuple(rows))
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed profile dump: {err}") from None


def render_folded(dump: ProfileDump) -> str:
    """Collapsed-stack text: one ``frames count`` line per row, the
    input format of flamegraph.pl and speedscope (OPERATIONS.md
    "Profiling & the thread ledger" has the full recipe)."""
    return "\n".join(f"{s.stack} {s.count}" for s in dump.stacks)


_THREAD_GAUGE_SUFFIXES = (".cpu_pct", ".utime_ms", ".stime_ms")


def thread_ledger(reg: dict) -> list[dict]:
    """Per-thread CPU rows from one registry snapshot's ``thread.*``
    gauges (ThreadRegistry::SampleInto), cpu%-descending then by name.
    Thread names contain dots and slashes (``dio.worker/1``), so parse
    by stripping the known prefix and suffix — never by splitting."""
    rows: dict[str, dict] = {}
    for name, v in reg.get("gauges", {}).items():
        if not name.startswith("thread."):
            continue
        for suffix in _THREAD_GAUGE_SUFFIXES:
            if name.endswith(suffix):
                tname = name[len("thread."):-len(suffix)]
                rows.setdefault(tname, {"name": tname, "cpu_pct": 0,
                                        "utime_ms": 0, "stime_ms": 0})
                rows[tname][suffix[1:]] = v
                break
    return sorted(rows.values(),
                  key=lambda r: (-r["cpu_pct"], r["name"]))


# ---------------------------------------------------------------------------
# gray-failure health decoding (HEALTH_STATUS / HEALTH_MATRIX;
# native/common/healthmon.h + tracker/cluster.cc).  Wire shapes pinned
# cross-language by the fdfs_codec health-status / health-matrix goldens.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HealthPeerRow:
    """One (peer address, op class) row from a daemon's health table.
    ``score`` is 0..100 (100 = healthy); the peer's composite score is
    the MINIMUM across its op classes."""
    addr: str
    op: str
    score: int
    rpc_ewma_us: int
    error_pct: int
    timeout_pct: int
    ops: int
    errors: int
    timeouts: int
    age_s: int


@dataclass(frozen=True)
class HealthStatus:
    """One daemon's HEALTH_STATUS view: its own gray score (watchdog +
    disk probes) plus its per-peer RPC health table."""
    role: str
    port: int
    score: int           # SelfScore: 0..100
    stalled_threads: int
    probe_read_us: int
    probe_write_us: int
    probe_threshold_ms: int
    peers: tuple         # HealthPeerRow, (addr, op)-sorted


def decode_health_status(obj: dict) -> HealthStatus:
    """Validate and decode one daemon's HEALTH_STATUS JSON (rows arrive
    (addr, op)-sorted; unknown extra keys are ignored — the wire
    contract is append-only)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("peers"), list):
        raise ValueError(f"health status must have a peers list: {obj!r}")
    rows: list[HealthPeerRow] = []
    for p in obj["peers"]:
        try:
            rows.append(HealthPeerRow(
                addr=str(p["addr"]), op=str(p["op"]), score=int(p["score"]),
                rpc_ewma_us=int(p["rpc_ewma_us"]),
                error_pct=int(p["error_pct"]),
                timeout_pct=int(p["timeout_pct"]), ops=int(p["ops"]),
                errors=int(p["errors"]), timeouts=int(p["timeouts"]),
                age_s=int(p["age_s"])))
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"malformed health peer {p!r}: {err}") from None
    if any((a.addr, a.op) > (b.addr, b.op) for a, b in zip(rows, rows[1:])):
        raise ValueError("health peers not (addr, op)-sorted")
    try:
        probe = dict(obj.get("probe", {}))
        return HealthStatus(
            role=str(obj["role"]), port=int(obj["port"]),
            score=int(obj["score"]),
            stalled_threads=int(obj["stalled_threads"]),
            probe_read_us=int(probe.get("read_us", 0)),
            probe_write_us=int(probe.get("write_us", 0)),
            probe_threshold_ms=int(probe.get("threshold_ms", 0)),
            peers=tuple(rows))
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed health status: {err}") from None


_HEALTH_VERDICTS = ("ok", "gray", "sick", "unknown")


@dataclass(frozen=True)
class HealthMatrixNode:
    """One node's row in the tracker's N x N differential matrix:
    what it SAYS about itself (``self_score``, -1 = never reported)
    against what its group peers SAY about it (``peer_avg``, -1 = no
    reports).  ``verdict`` is the tracker's call: a "gray" node claims
    healthy while peers score it under the threshold."""
    group: str
    addr: str
    self_score: int
    peer_avg: int
    reports: int
    verdict: str
    age_s: int
    peers: dict  # addr -> score THIS node reported about its peers


@dataclass(frozen=True)
class HealthMatrix:
    role: str
    port: int
    gray_threshold: int
    nodes: tuple  # HealthMatrixNode


def decode_health_matrix(obj: dict) -> HealthMatrix:
    """Validate and decode the tracker's HEALTH_MATRIX JSON (unknown
    extra keys are ignored — the wire contract is append-only)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("nodes"), list):
        raise ValueError(f"health matrix must have a nodes list: {obj!r}")
    nodes: list[HealthMatrixNode] = []
    for n in obj["nodes"]:
        try:
            verdict = str(n["verdict"])
            if verdict not in _HEALTH_VERDICTS:
                raise ValueError(f"unknown verdict {verdict!r}")
            nodes.append(HealthMatrixNode(
                group=str(n["group"]), addr=str(n["addr"]),
                self_score=int(n["self"]), peer_avg=int(n["peer_avg"]),
                reports=int(n["reports"]), verdict=verdict,
                age_s=int(n["age_s"]),
                peers={str(a): int(s)
                       for a, s in dict(n.get("peers", {})).items()}))
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"malformed matrix node {n!r}: {err}") from None
    try:
        return HealthMatrix(
            role=str(obj["role"]), port=int(obj["port"]),
            gray_threshold=int(obj["gray_threshold"]), nodes=tuple(nodes))
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed health matrix: {err}") from None


# ---------------------------------------------------------------------------
# admission-ladder decoding (ADMISSION_STATUS; native/storage/admission.h).
# Wire shape pinned cross-language by the fdfs_codec admission-json golden.
# ---------------------------------------------------------------------------

# Ladder rung names, index == level (mirror of AdmissionController's
# level_name(); level L sheds every class c with c + L > 4).
ADMISSION_LEVELS = ("admit-all", "shed-background", "shed-bulk", "reads-only")

# Priority-class names, index == class byte (mirror of
# PriorityClassName / protocol.PriorityClass).
PRIORITY_CLASSES = ("control", "interactive", "normal", "bulk", "background")


@dataclass(frozen=True)
class AdmissionStatus:
    """One daemon's ADMISSION_STATUS view: where the shed ladder sits
    right now and what it has refused so far."""
    role: str
    port: int
    enabled: bool
    level: int
    level_name: str
    pressure: float
    ewma: float
    tighten_threshold: float
    relax_threshold: float
    tightens: int
    relaxes: int
    retry_after_ms: int
    admitted: int
    shed: int
    shed_by_class: dict  # class name -> lifetime shed count


def decode_admission(obj: dict) -> AdmissionStatus:
    """Validate and decode one daemon's ADMISSION_STATUS JSON (unknown
    extra keys are ignored — the wire contract is append-only)."""
    if not isinstance(obj, dict):
        raise ValueError(f"admission status must be an object: {obj!r}")
    try:
        level = int(obj["level"])
        name = str(obj["level_name"])
        if not 0 <= level < len(ADMISSION_LEVELS):
            raise ValueError(f"level {level} out of range")
        if name != ADMISSION_LEVELS[level]:
            raise ValueError(f"level_name {name!r} does not match "
                             f"level {level}")
        by_class = {str(k): int(v)
                    for k, v in dict(obj.get("shed_by_class", {})).items()}
        if any(k not in PRIORITY_CLASSES for k in by_class):
            unknown = sorted(set(by_class) - set(PRIORITY_CLASSES))
            raise ValueError(f"unknown shed classes {unknown}")
        return AdmissionStatus(
            role=str(obj["role"]), port=int(obj["port"]),
            enabled=bool(obj["enabled"]), level=level, level_name=name,
            pressure=float(obj["pressure"]), ewma=float(obj["ewma"]),
            tighten_threshold=float(obj["tighten_threshold"]),
            relax_threshold=float(obj["relax_threshold"]),
            tightens=int(obj["tightens"]), relaxes=int(obj["relaxes"]),
            retry_after_ms=int(obj["retry_after_ms"]),
            admitted=int(obj["admitted"]), shed=int(obj["shed"]),
            shed_by_class=by_class)
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed admission status: {err}") from None


# ---------------------------------------------------------------------------
# SLO rule table (mirror of native/common/sloeval.cc; the fdfs_codec
# slo-conf golden pins the two parsers against each other)
# ---------------------------------------------------------------------------

# (name, threshold, clear) — breach when EWMA(reading) > threshold,
# recover when EWMA <= clear.  Must stay field-identical to
# SloEvaluator::DefaultRules().
DEFAULT_SLO_RULES = (
    ("error_rate_pct", 5.0, 2.5),
    ("request_p99_ms", 1000.0, 500.0),
    ("loop_lag_p99_ms", 250.0, 125.0),
    ("dio_wait_p99_ms", 500.0, 250.0),
    ("sync_lag_s", 300.0, 150.0),
    ("scrub_unrepairable", 0.5, 0.25),
    ("disk_fill_pct", 90.0, 85.0),
    ("peer_rpc_p99_ms", 1000.0, 500.0),
    ("probe_write_ms", 1000.0, 500.0),
)

_SLO_TRUE = {"1", "yes", "true", "on"}


def parse_slo_rules(text: str) -> list[tuple[str, float, float, bool]]:
    """conf/slo.conf -> [(name, threshold, clear, enabled)], applying
    ``<rule>_threshold`` / ``<rule>_clear`` / ``<rule>_enabled``
    overrides onto DEFAULT_SLO_RULES exactly like the C++ loader
    (including the proportional clear rescale when only the threshold
    is overridden)."""
    kv: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, value = line.partition("=")
        if sep:
            kv[key.strip()] = value.strip()

    def fget(key: str) -> float | None:
        # strtod semantics, like the C++ loader: parse the longest
        # numeric PREFIX and ignore trailing garbage ("70%" -> 70.0,
        # "300s" -> 300.0) — float() would reject those and silently
        # report the compiled-in default for a threshold the daemon is
        # actually enforcing.
        m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?",
                     kv.get(key, ""))
        return float(m.group(0)) if m else None

    out = []
    for name, dflt_threshold, dflt_clear in DEFAULT_SLO_RULES:
        threshold = fget(f"{name}_threshold")
        clear = fget(f"{name}_clear")
        if threshold is None:
            threshold = dflt_threshold
            if clear is None:
                clear = dflt_clear
        elif clear is None:
            clear = (threshold * (dflt_clear / dflt_threshold)
                     if dflt_threshold > 0 else dflt_clear)
        if clear > threshold:
            clear = threshold
        flag = kv.get(f"{name}_enabled", "").lower()
        if flag in _SLO_TRUE:
            enabled = True
        elif flag in {"0", "no", "false", "off"}:
            enabled = False
        else:
            enabled = True  # absent or unparseable: the C++ loader's default
        out.append((name, threshold, clear, enabled))
    return out


# ---------------------------------------------------------------------------
# histogram delta quantiles (the fdfs_top math)
# ---------------------------------------------------------------------------

def hist_delta(prev: dict | None, cur: dict) -> dict:
    """Bucket-wise delta of two registry histogram snapshots of the same
    metric — the distribution of observations BETWEEN the two polls.
    prev=None (first poll, or the daemon restarted and counts went
    backwards) returns cur unchanged.  Per-bucket deltas are CLAMPED at
    0: a restart the total-count guard cannot see (more new
    observations than the old lifetime had) must never render negative
    bucket mass."""
    if (prev is None or prev.get("bounds") != cur.get("bounds")
            or prev.get("count", 0) > cur.get("count", 0)):
        return cur
    counts = [max(c - p, 0) for p, c in zip(prev["counts"], cur["counts"])]
    return {
        "bounds": cur["bounds"],
        "counts": counts,
        "sum": max(cur["sum"] - prev["sum"], 0),
        "count": sum(counts),
    }


def hist_quantile(h: dict, q: float) -> float | None:
    """Upper-bound estimate of quantile ``q`` from a (delta) histogram:
    the inclusive upper bound of the bucket the quantile falls in.

    None — rendered as ``-`` — whenever no finite estimate exists: the
    histogram saw no observations, carries no buckets at all, or the
    quantile lands in the overflow bucket (all that is known there is
    "beyond the last bound"; an inf-ish number formatted into a latency
    column misleads more than it informs)."""
    bounds, counts = h.get("bounds"), h.get("counts")
    if not bounds or not counts:
        return None
    total = h.get("count", 0)
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    for bound, cnt in zip(bounds, counts):
        seen += cnt
        if seen >= rank:
            return float(bound)
    return None  # overflow bucket: no finite upper bound exists


# ---------------------------------------------------------------------------
# fdfs_top: sampling, delta rates, rendering
# ---------------------------------------------------------------------------

@dataclass
class NodeSample:
    role: str                    # "tracker" | "storage"
    addr: str                    # "ip:port"
    registry: dict | None = None
    error: str = ""


@dataclass
class TopSample:
    """One fdfs_top poll: every node's registry + the merged new events."""
    ts: float = 0.0
    nodes: dict[str, NodeSample] = field(default_factory=dict)
    events: list[ClusterEvent] = field(default_factory=list)
    cluster: dict = field(default_factory=dict)


def gather_top(client, group: str | None = None,
               seen_seq: dict[str, tuple[int, int]] | None = None
               ) -> TopSample:
    """Poll STAT + EVENT_DUMP across the cluster (trackers from the
    client's config, storages from SERVER_CLUSTER_STAT).  Best-effort
    like gather(): a dead node becomes a row with an error, never an
    exception.  ``seen_seq`` (mutated in place) maps node -> (seq,
    ts_us) of the newest event already consumed, so only NEW events
    land in the sample — with the ts doubling as an incarnation check
    (a restarted daemon's ring reuses low seqs with different
    timestamps)."""
    from fastdfs_tpu_torch.client.storage_client import StorageClient
    from fastdfs_tpu_torch.client.tracker_client import TrackerClient

    if seen_seq is None:
        seen_seq = {}
    out = TopSample(ts=time.time())

    def take_events(node: str, dump: dict) -> None:
        evs = decode_events(dump, node)
        last, last_ts = seen_seq.get(node, (0, 0))
        top = max((e.seq for e in evs), default=0)
        # Restart detection: the ring (1-based process-monotonic seq)
        # dies with the process, so after a restart everything in the
        # dump is new and must NOT be filtered against the dead
        # incarnation's high-water.  Two tells: the top seq regressed,
        # or the event still sitting at our high-water seq carries a
        # different timestamp than the one we consumed there.
        restarted = bool(top) and top < last
        if not restarted and last and last_ts:
            marker = next((e for e in evs if e.seq == last), None)
            restarted = marker is not None and marker.ts_us != last_ts
        if restarted:
            last = 0
        fresh = [e for e in evs if e.seq > last]
        if top:
            newest = max(evs, key=lambda e: e.seq)
            seen_seq[node] = (newest.seq, newest.ts_us)
        out.events.extend(fresh)

    storages: list[tuple[str, int]] = []
    for host, port in client.trackers:
        addr = f"{host}:{port}"
        node = NodeSample(role="tracker", addr=addr)
        try:
            with TrackerClient(host, port, client.timeout) as tc:
                node.registry = decode_registry(tc.stat())
                take_events(f"tracker {addr}", tc.event_dump())
                if not out.cluster:
                    out.cluster = tc.cluster_stat(group)
                    for g in out.cluster.get("groups", []):
                        for s in g.get("storages", []):
                            storages.append((s["ip"], s["port"]))
        except Exception as e:  # noqa: BLE001 — a dead node is a row
            node.error = f"{type(e).__name__}: {e}"
        out.nodes[f"tracker {addr}"] = node
    for ip, port in sorted(set(storages)):
        addr = f"{ip}:{port}"
        node = NodeSample(role="storage", addr=addr)
        try:
            with StorageClient(ip, port, client.timeout,
                               device=client.device) as sc:
                node.registry = decode_registry(sc.stat())
                take_events(f"storage {addr}", sc.event_dump())
        except Exception as e:  # noqa: BLE001
            node.error = f"{type(e).__name__}: {e}"
        out.nodes[f"storage {addr}"] = node
    return out


def _counter_sum(reg: dict, pattern: re.Pattern) -> int:
    return sum(v for name, v in reg["counters"].items()
               if pattern.fullmatch(name))


_OP_COUNT_RE = re.compile(r"op\.\w+\.count")
_OP_ERROR_RE = re.compile(r"op\.\w+\.errors")


def top_rates(prev: TopSample | None, cur: TopSample) -> dict[str, dict]:
    """Per-node delta rates between two polls: ops/s, err/s, MB/s in and
    out, cache hit %, loop-lag p99 and dio queue-wait p99 (µs, from
    histogram deltas), plus instantaneous queue depth and connections.
    With prev=None (first frame) every rate reads 0 — the gauges and
    quantiles of the lifetime histograms still render."""
    dt = max(cur.ts - prev.ts, 1e-3) if prev is not None else None
    out: dict[str, dict] = {}
    for node, s in cur.nodes.items():
        if s.registry is None:
            out[node] = {"error": s.error}
            continue
        reg = s.registry
        p = prev.nodes.get(node) if prev is not None else None
        preg = p.registry if p is not None and p.registry is not None else None

        def counters(r): return r["counters"]
        def gauge(r, name): return r["gauges"].get(name, 0)

        def crate(cur_v: int, prev_v: int) -> float:
            if dt is None or cur_v < prev_v:  # first frame / restart
                return 0.0
            return (cur_v - prev_v) / dt

        if s.role == "tracker":
            ops = counters(reg).get("server.requests", 0)
            errs = counters(reg).get("server.errors", 0)
            pops = counters(preg).get("server.requests", 0) if preg else 0
            perrs = counters(preg).get("server.errors", 0) if preg else 0
            up = down = pup = pdown = 0
            hits = misses = phits = pmisses = 0
        else:
            ops = _counter_sum(reg, _OP_COUNT_RE)
            errs = _counter_sum(reg, _OP_ERROR_RE)
            pops = _counter_sum(preg, _OP_COUNT_RE) if preg else 0
            perrs = _counter_sum(preg, _OP_ERROR_RE) if preg else 0
            up, down = gauge(reg, "store.bytes_uploaded"), gauge(
                reg, "store.bytes_downloaded")
            pup = gauge(preg, "store.bytes_uploaded") if preg else 0
            pdown = gauge(preg, "store.bytes_downloaded") if preg else 0
            hits, misses = gauge(reg, "cache.hits"), gauge(reg, "cache.misses")
            phits = gauge(preg, "cache.hits") if preg else 0
            pmisses = gauge(preg, "cache.misses") if preg else 0

        dh, dm = max(hits - phits, 0), max(misses - pmisses, 0)
        lag = reg["histograms"].get("nio.loop_lag_us")
        dio = reg["histograms"].get("dio.queue_wait_us")
        plag = preg["histograms"].get("nio.loop_lag_us") if preg else None
        pdio = preg["histograms"].get("dio.queue_wait_us") if preg else None
        # Counter reset = daemon restart between polls.  Every delta is
        # clamped at 0 (crate/hist_delta do that), and the row carries an
        # explicit flag so the operator sees WHY its rates read zero —
        # a silently-zero row after a crash looks like "idle", which is
        # the opposite of the truth.
        restarted = preg is not None and (ops < pops or errs < perrs)
        out[node] = {
            "role": s.role,
            "restarted": restarted,
            "ops_s": round(crate(ops, pops), 1),
            "err_s": round(crate(errs, perrs), 1),
            "in_mb_s": round(crate(up, pup) / 1e6, 2),
            "out_mb_s": round(crate(down, pdown) / 1e6, 2),
            "cache_hit_pct": (round(100.0 * dh / (dh + dm), 1)
                              if dh + dm > 0 else None),
            "loop_p99_us": (hist_quantile(hist_delta(plag, lag), 0.99)
                            if lag else None),
            "dio_wait_p99_us": (hist_quantile(hist_delta(pdio, dio), 0.99)
                                if dio else None),
            "dio_depth": reg["gauges"].get("dio.queue_depth"),
            "conns": reg["gauges"].get("nio.conns_active", 0),
            "slo_breaches": reg["gauges"].get("slo.breaches_active", 0),
            # Gray-failure health gauges (healthmon.h PublishGauges).
            # None = this daemon publishes no health (tracker, or a
            # storage predating the health layer) — the HEALTH pane
            # skips it rather than showing a fake 100.
            "health_score": reg["gauges"].get("health.score"),
            "stalled_threads": reg["gauges"].get(
                "watchdog.stalled_threads", 0),
            "worst_peer": _worst_peer_gauge(reg),
            # Admission-ladder gauges (admission.h PublishGauges).
            # None = this daemon predates the admission layer — the
            # ADMISSION pane skips it rather than inventing level 0.
            "admission_level": reg["gauges"].get("admission.level"),
            "shed_s": round(crate(gauge(reg, "admission.shed_total"),
                                  gauge(preg, "admission.shed_total")
                                  if preg else 0), 1),
        }
    return out


def _worst_peer_gauge(reg: dict) -> tuple[str, int] | None:
    """(addr, score) of the lowest-scored peer in this registry's
    ``peer.<addr>.score`` gauge family, or None when the family is
    empty.  Addresses contain dots and colons, so parse by stripping
    the known prefix and suffix — never by splitting."""
    worst: tuple[str, int] | None = None
    for name, v in reg["gauges"].items():
        if not name.startswith("peer.") or not name.endswith(".score"):
            continue
        addr = name[len("peer."):-len(".score")]
        if worst is None or v < worst[1]:
            worst = (addr, v)
    return worst


def _fmt_us(v: float | None) -> str:
    if v is None:
        return "-"
    if v >= 1e6:
        return f"{v / 1e6:.1f}s"
    if v >= 1000:
        return f"{v / 1000:.1f}ms"
    return f"{v:.0f}us"


def render_top(cur: TopSample, rates: dict[str, dict],
               recent_events: list[ClusterEvent],
               max_events: int = 10,
               alerts: dict[str, list[str]] | None = None,
               heat: dict[str, list["HeatEntry"]] | None = None,
               heat_rows: int = 5,
               threads: dict[str, list[dict]] | None = None,
               thread_rows: int = 8,
               hot_map: dict | None = None) -> str:
    """The fdfs_top frame: a per-node saturation table, an ALERTS line
    (active SLO breaches per node), the scrolling recent-events pane,
    with ``heat`` a per-node hot-file pane, and with ``threads`` a
    per-node THREADS pane (the thread ledger, cpu%-descending).  Pure
    string building so tests (and --json consumers) can drive it
    headless."""
    cols = (f"{'node':<32} {'ops/s':>8} {'err/s':>6} {'in MB/s':>8} "
            f"{'out MB/s':>8} {'hit%':>6} {'loop p99':>9} {'dio p99':>9} "
            f"{'depth':>5} {'conns':>5}")
    lines = [time.strftime("fdfs_top  %H:%M:%S", time.localtime(cur.ts)),
             cols, "-" * len(cols)]
    for node, r in rates.items():
        if "error" in r and "role" not in r:
            lines.append(f"{node:<32} DOWN: {r['error']}")
            continue
        hit = "-" if r["cache_hit_pct"] is None else f"{r['cache_hit_pct']}"
        depth = "-" if r["dio_depth"] is None else str(r["dio_depth"])
        # A restarted daemon's rates read 0 by clamping; say why.
        mark = "  RESTARTED" if r.get("restarted") else ""
        lines.append(
            f"{node:<32} {r['ops_s']:>8} {r['err_s']:>6} {r['in_mb_s']:>8} "
            f"{r['out_mb_s']:>8} {hit:>6} {_fmt_us(r['loop_p99_us']):>9} "
            f"{_fmt_us(r['dio_wait_p99_us']):>9} {depth:>5} {r['conns']:>5}"
            f"{mark}")
    # GROUPS line: shown only while a group is draining/retired — the
    # aggregate rebalance progress of the multi-group scale-out story.
    drains = [g for g in (cur.cluster or {}).get("groups", [])
              if g.get("state", "active") != "active"]
    if drains:
        parts = []
        for g in drains:
            moved = pending = errors = done = n = 0
            for s in g.get("storages", []):
                st = beat_stats_from_storage(s)
                moved += st.get("rebalance_files_moved", 0)
                pending += st.get("rebalance_files_pending", 0)
                errors += st.get("rebalance_errors", 0)
                done += 1 if st.get("rebalance_done", 0) else 0
                n += 1
            parts.append(f"{g['name']} {g['state']}: moved={moved} "
                         f"pending={pending} errors={errors} done={done}/{n}")
        lines.append("")
        lines.append("GROUPS: " + "; ".join(parts))
    # ALERTS line: one glance answers "is anything red right now".
    # Event-tracked alerts name their rules; nodes whose breach predates
    # this fdfs_top (no slo.breach event seen, only the gauge) fall back
    # to a count — summed over the NOT-already-named nodes only, so a
    # live alert on one node cannot hide or double-count another's.
    active = [(node, rules) for node, rules in sorted((alerts or {}).items())
              if rules]
    named = {node for node, _ in active}
    breach_gauges = sum(r.get("slo_breaches") or 0
                        for node, r in rates.items()
                        if "role" in r and node not in named)
    parts = [f"{node}: {','.join(rules)}" for node, rules in active]
    if breach_gauges:
        parts.append(f"{breach_gauges} pre-existing breach(es) "
                     "(details in events pane)")
    if parts:
        lines.append("")
        lines.append("ALERTS: " + "; ".join(parts))
    # HEALTH line: the gray-failure glance — each health-publishing
    # node's self score, stalled-thread count, and its worst-scored
    # peer.  Sorted worst-first so the gray node leads the line.
    health = []
    for node, r in rates.items():
        if r.get("health_score") is None:
            continue
        part = f"{node}: self={r['health_score']}"
        if r.get("stalled_threads"):
            part += f" stalled={r['stalled_threads']}"
        if r.get("worst_peer") is not None:
            paddr, pscore = r["worst_peer"]
            part += f" worst-peer={paddr}={pscore}"
        health.append((r["health_score"], part))
    if health:
        lines.append("")
        lines.append("HEALTH: " +
                     "; ".join(p for _, p in sorted(
                         health, key=lambda h: (h[0], h[1]))))
    # ADMISSION line: shown only while some node is actually shedding
    # (level > 0 or a nonzero shed rate) — at admit-all it is noise.
    # Sorted tightest-first so the overloaded node leads the line.
    admission = []
    for node, r in rates.items():
        lvl = r.get("admission_level")
        if lvl is None or (lvl == 0 and not r.get("shed_s")):
            continue
        name = (ADMISSION_LEVELS[lvl] if 0 <= lvl < len(ADMISSION_LEVELS)
                else str(lvl))
        admission.append(
            (-lvl, node, f"{node}: {name} shed/s={r.get('shed_s', 0)}"))
    if admission:
        lines.append("")
        lines.append("ADMISSION: " +
                     "; ".join(p for _, _, p in sorted(admission)))
    # HOT line: the elastic-replication glance — shown only while the
    # tracker's hot map actually publishes entries (a decoded
    # QUERY_HOT_MAP snapshot, monitor.decode_hot_map shape).
    if hot_map and hot_map.get("entries"):
        shown = hot_map["entries"][:3]
        parts = [f"{e['key']}->{','.join(e['groups'])}" for e in shown]
        extra = len(hot_map["entries"]) - len(shown)
        if extra > 0:
            parts.append(f"(+{extra} more)")
        lines.append("")
        lines.append(f"HOT: v{hot_map.get('version', 0)} "
                     f"published={len(hot_map['entries'])}; "
                     + "; ".join(parts))
    lines.append("")
    lines.append(f"recent events (last {max_events}):")
    for e in recent_events[-max_events:]:
        ts = time.strftime("%H:%M:%S", time.localtime(e.ts_us / 1e6))
        lines.append(f"  {ts} {e.severity.upper():<5} [{e.node}] "
                     f"{e.type} {e.key} {e.detail}".rstrip())
    if not recent_events:
        lines.append("  (none)")
    if heat is not None:
        lines.append("")
        lines.append(f"hot files (top {heat_rows} per node, "
                     "hits / err-bound / MB / ops):")
        lines.extend(_heat_table_lines(heat, heat_rows))
    if threads is not None:
        lines.append("")
        lines.append(f"THREADS (top {thread_rows} per node, "
                     "cpu% / user ms / sys ms):")
        lines.extend(_thread_table_lines(threads, thread_rows))
    return "\n".join(lines)


def _heat_table_lines(heat: dict[str, list["HeatEntry"]],
                      heat_rows: int) -> list[str]:
    """Shared per-node hot-file table body — fdfs_top's --heat pane and
    fdfs_report's heat section must render the same HeatEntry data
    identically."""
    lines: list[str] = []
    for node in sorted(heat):
        lines.append(f"  {node}:")
        entries = heat[node][:heat_rows]
        if not entries:
            lines.append("    (none)")
        for he in entries:
            ops = " ".join(f"{op}={c['count']}"
                           for op, c in sorted(he.ops.items())
                           if c["count"] > 0)
            lines.append(f"    {he.hits:>8} ±{he.err_bound:<6} "
                         f"{he.bytes / 1e6:>8.1f}MB  {he.key}  [{ops}]")
    return lines


def _thread_table_lines(threads: dict[str, list[dict]],
                        thread_rows: int) -> list[str]:
    """Per-node thread-ledger table body (rows from thread_ledger),
    shared so fdfs_top's THREADS pane and any report renderer show the
    same numbers identically."""
    lines: list[str] = []
    for node in sorted(threads):
        lines.append(f"  {node}:")
        rows = threads[node][:thread_rows]
        if not rows:
            lines.append("    (none)")
        for r in rows:
            lines.append(f"    {r['cpu_pct']:>4}% {r['utime_ms']:>8}u "
                         f"{r['stime_ms']:>8}s  {r['name']}")
    return lines


# ---------------------------------------------------------------------------
# text rendering (fdfs_monitor.c analogue)
# ---------------------------------------------------------------------------

def render_text(snap: ClusterSnapshot) -> str:
    t = snap.tracker
    lines = [
        f"tracker: leader={t.get('leader', '')!s} "
        f"am_leader={t.get('am_leader', False)} "
        f"groups={t.get('groups', len(snap.groups))}",
        f"group count: {len(snap.groups)}",
    ]
    for g in snap.groups:
        lines.append("")
        state = g.get("state", "active")
        lines.append(
            f"Group: {g['name']}  state={state}  members={g['members']} "
            f"active={g['active']} free={g['free_mb']}MB "
            f"trunk_server={g.get('trunk_server', '') or '-'}")
        for s in g.get("storages", []):
            addr = f"{s['ip']}:{s['port']}"
            st = beat_stats_from_storage(s)
            lines.append(
                f"  {addr} {s.get('status_name', s['status'])} "
                f"beat_age={s.get('beat_age_s', -1)}s "
                f"disk={s['free_mb']}/{s['total_mb']}MB "
                f"upload={st['success_upload']}/{st['total_upload']} "
                f"download={st['success_download']}/{st['total_download']} "
                f"delete={st['success_delete']}/{st['total_delete']} "
                f"dedup_hits={st['dedup_hits']} "
                f"saved={st['dedup_bytes_saved']}B "
                f"wire_saved={st['sync_bytes_saved_wire']}B "
                f"sync_lag={st['sync_lag_s']}s "
                f"recovery={st['recovery_chunks_fetched']}f/"
                f"{st['recovery_chunks_local']}l")
            if state != "active":
                done = " done" if st.get("rebalance_done", 0) else ""
                lines[-1] += (
                    f" rebalance={st.get('rebalance_files_moved', 0)}moved/"
                    f"{st.get('rebalance_files_pending', 0)}pending"
                    f"{done}")
            reg = snap.storage_stats.get(addr)
            if reg is not None:
                ops = []
                for name, v in sorted(reg["counters"].items()):
                    m = re.fullmatch(r"op\.(\w+)\.count", name)
                    if m and v > 0:
                        ops.append(f"{m.group(1)}={v}")
                if ops:
                    lines.append(f"    ops: {' '.join(ops)}")
            err = snap.storage_errors.get(addr)
            if err is not None:
                lines.append(f"    stat error: {err}")
    return "\n".join(lines)


def beat_stats_from_storage(s: dict) -> dict[str, int]:
    """Named beat stats from a cluster_stat storage entry; tolerates both
    the named dict (native tracker) and a raw vector."""
    st = s.get("stats", {})
    if isinstance(st, list):
        return beat_stats(st)
    return {name: int(st.get(name, 0)) for name in BEAT_STAT_FIELDS}


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(raw: str, prefix: str = "fdfs") -> str:
    name = _NAME_RE.sub("_", raw)
    if name and name[0].isdigit():
        name = "_" + name
    return f"{prefix}_{name}"


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels(**kv) -> str:
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in kv.items() if v is not None)
    return "{" + inner + "}" if inner else ""


def to_prometheus(snap: ClusterSnapshot, prefix: str = "fdfs") -> str:
    """Text exposition format (one scrape = one cluster snapshot).

    Beat stats become per-storage series labelled {group,storage};
    registry counters/gauges keep their registry name (sanitized) with a
    {storage} label; registry histograms become standard cumulative
    ``_bucket{le=...}`` series."""
    out: list[str] = []

    def emit(name: str, mtype: str, samples: list[tuple[str, int | float]]):
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            out.append(f"{name}{labels} {value}")

    t = snap.tracker
    emit(f"{prefix}_tracker_is_leader", "gauge",
         [(_labels(leader=t.get("leader", "")),
           1 if t.get("am_leader") else 0)])
    emit(f"{prefix}_group_active_storages", "gauge",
         [(_labels(group=g["name"]), g["active"]) for g in snap.groups])
    emit(f"{prefix}_group_free_mb", "gauge",
         [(_labels(group=g["name"]), g["free_mb"]) for g in snap.groups])

    storages = [(g, s) for g in snap.groups for s in g.get("storages", [])]
    if storages:
        emit(f"{prefix}_storage_status", "gauge",
             [(_labels(group=g["name"], storage=f"{s['ip']}:{s['port']}"),
               s["status"]) for g, s in storages])
        emit(f"{prefix}_storage_beat_age_seconds", "gauge",
             [(_labels(group=g["name"], storage=f"{s['ip']}:{s['port']}"),
               s.get("beat_age_s", -1)) for g, s in storages])
        for fname in BEAT_STAT_FIELDS:
            mtype = "gauge" if fname in _BEAT_GAUGES else "counter"
            emit(f"{prefix}_storage_{fname}", mtype,
                 [(_labels(group=g["name"],
                           storage=f"{s['ip']}:{s['port']}"),
                   beat_stats_from_storage(s)[fname])
                  for g, s in storages])

    # Registry metrics must be grouped BY NAME across storages first: the
    # text format allows exactly one TYPE line per metric name, and the
    # multi-storage case would otherwise repeat it (scrapers reject the
    # whole exposition on a duplicate TYPE line).
    counters: dict[str, list] = {}
    gauges: dict[str, list] = {}
    hists: dict[str, list] = {}
    # peer.<addr>.<metric> health gauges become ONE labeled family per
    # metric ({storage, peer}) instead of one mangled metric name per
    # peer address — the generic sanitizer would mint unbounded metric
    # names as peers churn, which scrapers treat as new series forever.
    peer_rows: dict[str, list] = {}
    _PEER_METRICS = ("score", "rpc_ewma_us", "error_pct", "timeout_pct")
    for addr in sorted(snap.storage_stats):
        reg = snap.storage_stats[addr]
        for name, v in reg["counters"].items():
            counters.setdefault(name, []).append((addr, v))
        for name, v in reg["gauges"].items():
            peered = False
            if name.startswith("peer."):
                for m in _PEER_METRICS:
                    if name.endswith("." + m):
                        peer = name[len("peer."):-len(m) - 1]
                        peer_rows.setdefault(m, []).append((addr, peer, v))
                        peered = True
                        break
            if not peered:
                gauges.setdefault(name, []).append((addr, v))
        for name, h in reg["histograms"].items():
            hists.setdefault(name, []).append((addr, h))
    for name in sorted(counters):
        emit(_metric_name(name, prefix), "counter",
             [(_labels(storage=addr), v) for addr, v in counters[name]])
    for name in sorted(gauges):
        emit(_metric_name(name, prefix), "gauge",
             [(_labels(storage=addr), v) for addr, v in gauges[name]])
    for m in sorted(peer_rows):
        emit(f"{prefix}_peer_{m}", "gauge",
             [(_labels(storage=addr, peer=peer), v)
              for addr, peer, v in peer_rows[m]])
    for name in sorted(hists):
        base = _metric_name(name, prefix)
        out.append(f"# TYPE {base} histogram")
        for addr, h in hists[name]:
            cum = 0
            for bound, cnt in zip(h["bounds"], h["counts"]):
                cum += cnt
                out.append(f'{base}_bucket{_labels(storage=addr, le=bound)} '
                           f"{cum}")
            cum += h["counts"][-1]
            out.append(f'{base}_bucket{_labels(storage=addr, le="+Inf")} '
                       f"{cum}")
            out.append(f"{base}_sum{_labels(storage=addr)} {h['sum']}")
            out.append(f"{base}_count{_labels(storage=addr)} {h['count']}")
    return "\n".join(out) + "\n"


# Beat fields that are levels, not monotonic totals.
_BEAT_GAUGES = frozenset({
    "last_source_update", "connections", "sync_lag_s",
    "rebalance_files_pending", "rebalance_done",
})


# ---------------------------------------------------------------------------
# fdfs_report: retrospective time-series from the metrics journal +
# breach timeline + heat tables (cli.py report)
# ---------------------------------------------------------------------------

@dataclass
class ReportData:
    """Everything one fdfs_report run gathered, per node."""
    since_us: int = 0
    # node -> [{"ts_us", "registry"}, ...] (decode_metrics_history shape)
    history: dict[str, list[dict]] = field(default_factory=dict)
    # node -> [ClusterEvent, ...] (full EVENT_DUMP, slo.* filtered later)
    events: dict[str, list[ClusterEvent]] = field(default_factory=dict)
    # node -> [HeatEntry, ...] (storages only)
    heat: dict[str, list[HeatEntry]] = field(default_factory=dict)
    errors: dict[str, str] = field(default_factory=dict)


def gather_report(client, since_us: int = 0, group: str | None = None,
                  heat_k: int = 0) -> ReportData:
    """Poll METRICS_HISTORY + EVENT_DUMP (+ HEAT_TOP on storages) across
    the cluster.  Best-effort per node (a dead or journal-less node
    becomes an errors entry), so a post-mortem of a half-up cluster
    still reports everything reachable."""
    from fastdfs_tpu_torch.client.conn import StatusError
    from fastdfs_tpu_torch.client.storage_client import StorageClient
    from fastdfs_tpu_torch.client.tracker_client import TrackerClient

    out = ReportData(since_us=since_us)
    storages: list[tuple[str, int]] = []
    for host, port in client.trackers:
        node = f"tracker {host}:{port}"
        try:
            with TrackerClient(host, port, client.timeout) as tc:
                if not storages:
                    cs = tc.cluster_stat(group)
                    for g in cs.get("groups", []):
                        for s in g.get("storages", []):
                            storages.append((s["ip"], s["port"]))
                out.history[node] = decode_metrics_history(
                    tc.metrics_history(since_us))
                out.events[node] = decode_events(tc.event_dump(), node)
        except StatusError as e:
            out.errors[node] = ("no metrics journal (ENOTSUP)"
                                if e.status == 95 else str(e))
        except Exception as e:  # noqa: BLE001 — a dead node is a row
            out.errors[node] = f"{type(e).__name__}: {e}"
    for ip, port in sorted(set(storages)):
        node = f"storage {ip}:{port}"
        try:
            with StorageClient(ip, port, client.timeout,
                               device=client.device) as sc:
                out.history[node] = decode_metrics_history(
                    sc.metrics_history(since_us))
                out.events[node] = decode_events(sc.event_dump(), node)
                try:
                    out.heat[node] = decode_heat(sc.heat_top(heat_k))
                except StatusError as e:
                    if e.status != 95:  # heat off is fine, else surface
                        raise
        except StatusError as e:
            out.errors[node] = ("no metrics journal (ENOTSUP)"
                                if e.status == 95 else str(e))
        except Exception as e:  # noqa: BLE001
            out.errors[node] = f"{type(e).__name__}: {e}"
    return out


_OP_LATENCY_RE = re.compile(r"op\.\w+\.latency_us")


def report_series(history: list[dict]) -> list[dict]:
    """Per-interval derived rows from one node's journal window: for
    each consecutive snapshot pair, the interval's ops/s, err/s, MB/s
    in/out, request p99, loop-lag p99 and dio-wait p99 (same delta math
    as fdfs_top, applied retrospectively).  Counter resets inside the
    window (the daemon restarted mid-journal) clamp to zero-rate rows
    flagged ``restarted`` rather than rendering garbage."""
    rows: list[dict] = []
    for prev, cur in zip(history, history[1:]):
        preg, reg = prev["registry"], cur["registry"]
        dt = max((cur["ts_us"] - prev["ts_us"]) / 1e6, 1e-3)

        ops = _counter_sum(reg, _OP_COUNT_RE) + reg["counters"].get(
            "server.requests", 0)
        pops = _counter_sum(preg, _OP_COUNT_RE) + preg["counters"].get(
            "server.requests", 0)
        errs = _counter_sum(reg, _OP_ERROR_RE) + reg["counters"].get(
            "server.errors", 0)
        perrs = _counter_sum(preg, _OP_ERROR_RE) + preg["counters"].get(
            "server.errors", 0)
        up = reg["gauges"].get("store.bytes_uploaded", 0)
        pup = preg["gauges"].get("store.bytes_uploaded", 0)
        down = reg["gauges"].get("store.bytes_downloaded", 0)
        pdown = preg["gauges"].get("store.bytes_downloaded", 0)
        restarted = ops < pops or errs < perrs

        def rate(c, p):
            return 0.0 if restarted or c < p else (c - p) / dt

        # Merged per-op latency delta (all op histograms share bounds).
        merged = None
        for name, h in reg["histograms"].items():
            if not (_OP_LATENCY_RE.fullmatch(name)
                    or name == "server.request_us"):
                continue
            d = hist_delta(preg["histograms"].get(name), h)
            if merged is None:
                merged = {"bounds": list(d["bounds"]),
                          "counts": list(d["counts"]),
                          "sum": d["sum"], "count": d["count"]}
            elif merged["bounds"] == d["bounds"]:
                merged["counts"] = [a + b for a, b in
                                    zip(merged["counts"], d["counts"])]
                merged["sum"] += d["sum"]
                merged["count"] += d["count"]

        def p99(name):
            h = reg["histograms"].get(name)
            if h is None:
                return None
            return hist_quantile(
                hist_delta(preg["histograms"].get(name), h), 0.99)

        rows.append({
            "ts_us": cur["ts_us"],
            "dt_s": round(dt, 3),
            "restarted": restarted,
            "ops_s": round(rate(ops, pops), 1),
            "err_s": round(rate(errs, perrs), 1),
            "in_mb_s": round(rate(up, pup) / 1e6, 2),
            "out_mb_s": round(rate(down, pdown) / 1e6, 2),
            "req_p99_us": (hist_quantile(merged, 0.99)
                           if merged is not None else None),
            "loop_p99_us": p99("nio.loop_lag_us"),
            "dio_wait_p99_us": p99("dio.queue_wait_us"),
            "slo_breaches": reg["gauges"].get("slo.breaches_active", 0),
        })
    return rows


def breach_timeline(events: dict[str, list[ClusterEvent]],
                    since_us: int = 0,
                    history: dict[str, list[dict]] | None = None
                    ) -> list[ClusterEvent]:
    """Every slo.breach / slo.recovered event across the cluster, time
    ordered — the report's alert timeline.

    The flight-recorder ring is RAM: a kill -9 takes its events with
    it.  The journal survives, and it carries the slo.breaches_active
    gauge per tick — so for any window OLDER than a node's oldest live
    event (crash, restart, or ring wrap), breach/recovery transitions
    are reconstructed from consecutive journal snapshots and appear as
    synthesized entries (key ``breaches_active``, detail
    ``source=journal``).  Live ring events always win inside their own
    coverage window — they carry the rule name and readings."""
    out = [e for evs in events.values() for e in evs
           if e.type in ("slo.breach", "slo.recovered")
           and e.ts_us >= since_us]
    for node, hist in (history or {}).items():
        live = events.get(node, [])
        ring_start = min((e.ts_us for e in live), default=float("inf"))
        for prev, cur in zip(hist, hist[1:]):
            if cur["ts_us"] >= ring_start:
                break  # the live ring covers it from here on
            was = prev["registry"]["gauges"].get("slo.breaches_active", 0)
            now = cur["registry"]["gauges"].get("slo.breaches_active", 0)
            if now == was or cur["ts_us"] < since_us:
                continue
            out.append(ClusterEvent(
                seq=0, ts_us=cur["ts_us"],
                severity="error" if now > was else "info",
                type="slo.breach" if now > was else "slo.recovered",
                key="breaches_active",
                detail=f"source=journal active={now}", node=node))
    return sorted(out, key=lambda e: (e.ts_us, e.node, e.seq))


def render_report(data: ReportData, max_rows: int = 12,
                  heat_rows: int = 5) -> str:
    """The fdfs_report text: per-node rate/latency time-series over the
    journal window (last ``max_rows`` intervals), the SLO breach
    timeline, and the per-node heat tables."""
    lines: list[str] = []
    for node in sorted(data.history):
        rows = report_series(data.history[node])
        lines.append(f"== {node}  ({len(data.history[node])} snapshots, "
                     f"{len(rows)} intervals)")
        if not rows:
            lines.append("   (not enough history for rates)")
            continue
        cols = (f"   {'time':<8} {'ops/s':>8} {'err/s':>6} {'in MB/s':>8} "
                f"{'out MB/s':>8} {'req p99':>9} {'loop p99':>9} "
                f"{'dio p99':>9} {'slo':>4}")
        lines.append(cols)
        for r in rows[-max_rows:]:
            ts = time.strftime("%H:%M:%S", time.localtime(r["ts_us"] / 1e6))
            mark = " RESTARTED" if r["restarted"] else ""
            lines.append(
                f"   {ts:<8} {r['ops_s']:>8} {r['err_s']:>6} "
                f"{r['in_mb_s']:>8} {r['out_mb_s']:>8} "
                f"{_fmt_us(r['req_p99_us']):>9} "
                f"{_fmt_us(r['loop_p99_us']):>9} "
                f"{_fmt_us(r['dio_wait_p99_us']):>9} "
                f"{r['slo_breaches']:>4}{mark}")
    lines.append("")
    lines.append("SLO breach timeline:")
    timeline = breach_timeline(data.events, data.since_us, data.history)
    if not timeline:
        lines.append("  (no breaches in the window)")
    for e in timeline:
        ts = time.strftime("%H:%M:%S", time.localtime(e.ts_us / 1e6))
        lines.append(f"  {ts} {e.severity.upper():<5} [{e.node}] "
                     f"{e.type} {e.key} {e.detail}".rstrip())
    if data.heat:
        lines.append("")
        lines.append(f"hot files (top {heat_rows} per node, "
                     "hits / err-bound / MB / ops):")
        lines.extend(_heat_table_lines(data.heat, heat_rows))
    for node, err in sorted(data.errors.items()):
        lines.append(f"{node}  error: {err}")
    return "\n".join(lines)
