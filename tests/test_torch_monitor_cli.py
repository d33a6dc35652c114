"""The port's ``monitor.py`` and ``cli.py`` against the reference's.

Monitor: every decoder, the rate and quantile math and every renderer
run on the same seeded blobs (registry snapshots, event dumps, metrics
histories, heat and hot-map dumps, profiles, health and admission
status, cluster dumps) through both packages; results, rendered text
and raised errors must be equal.

CLI: every tool runs through ``fastdfs_tpu.cli.main`` and
``fastdfs_tpu_torch.cli.main(["--device", "cpu", ...])``, each over
fresh scripted fake daemons (those of ``tests/test_torch_client_wire.py``,
extended to answer the monitor's opcodes with the same seeded blobs).
Stdout, stderr, the exit code and every frame the fakes read must be
equal once the fakes' own TCP ports (and, for ``trace`` and ``top``,
trace ids, wall-clock times and durations) are named by role.
Tolerance: exact equality.
"""

import contextlib
import dataclasses
import io
import json
import os
import random
import re
import struct

import pytest

from fastdfs_tpu import cli as R_cli
from fastdfs_tpu import monitor as R_mon
from fastdfs_tpu.common.fileid import encode_file_id
from fastdfs_tpu_torch import cli as T_cli
from fastdfs_tpu_torch import monitor as T_mon
from fastdfs_tpu_torch.client import client as T_client
from tests.test_torch_client_wire import (GROUP, FakeStorage, FakeTracker,
                                          _g16)

SEEDS = (0, 1, 2)
_I64 = struct.Struct(">q")
TRACE_ID = 0xAB12


# ---------------------------------------------------------------------------
# seeded blobs, shaped as the daemons' JSON and binary feeds
# ---------------------------------------------------------------------------

def _hist(rng, scale):
    bounds = [10, 100, 1000, 10_000, 100_000]
    counts = [rng.randrange(0, scale) for _ in range(len(bounds) + 1)]
    return {"bounds": bounds, "counts": counts,
            "sum": sum(c * b for c, b in zip(counts, bounds + [200_000])),
            "count": sum(counts)}


def registry(rng, role, step=1):
    """One STAT snapshot; ``step`` scales the lifetime counters, so a
    later step of the same seed is a later snapshot of the same daemon."""
    def grow(n):
        return n * step + rng.randrange(0, 5)
    counters, gauges = {}, {}
    if role == "tracker":
        counters["server.requests"] = grow(300)
        counters["server.errors"] = grow(2)
    else:
        for op in ("upload", "download", "delete"):
            counters[f"op.{op}.count"] = grow(rng.randrange(10, 400))
            counters[f"op.{op}.errors"] = grow(rng.randrange(0, 3))
        gauges.update({
            "store.bytes_uploaded": grow(5_000_000),
            "store.bytes_downloaded": grow(9_000_000),
            "cache.hits": grow(700), "cache.misses": grow(90),
            "dio.queue_depth": rng.randrange(0, 9),
            "health.score": rng.randrange(40, 101),
            "watchdog.stalled_threads": rng.randrange(0, 2),
            "peer.127.0.0.9:23001.score": rng.randrange(30, 101),
            "peer.127.0.0.9:23001.rpc_ewma_us": rng.randrange(100, 9000),
            "peer.127.0.0.8:23001.score": rng.randrange(30, 101),
            "admission.level": rng.choice((0, 0, 1, 2)),
            "admission.shed_total": grow(rng.randrange(0, 20)),
            "hot.fanout_replicated": rng.randrange(0, 9),
            "hot.fanout_queue": rng.randrange(0, 3),
        })
        for t in ("dio.worker/1", "nio.loop", "sync.peer/127.0.0.9"):
            gauges[f"thread.{t}.cpu_pct"] = rng.randrange(0, 100)
            gauges[f"thread.{t}.utime_ms"] = rng.randrange(0, 10_000)
            gauges[f"thread.{t}.stime_ms"] = rng.randrange(0, 10_000)
    gauges.update({"nio.conns_active": rng.randrange(0, 40),
                   "slo.breaches_active": rng.choice((0, 0, 1)),
                   "hot.map_version": 3, "hot.promoted": 1})
    hists = {"nio.loop_lag_us": _hist(rng, 50 * step),
             "dio.queue_wait_us": _hist(rng, 40 * step)}
    if role == "tracker":
        hists["server.request_us"] = _hist(rng, 60 * step)
    else:
        hists["op.upload.latency_us"] = _hist(rng, 30 * step)
        hists["op.download.latency_us"] = _hist(rng, 30 * step)
    return {"counters": counters, "gauges": gauges, "histograms": hists}


EVENT_TYPES = ("slo.breach", "slo.recovered", "chunk.quarantine",
               "gc.sweep", "session.expired")


def events(rng, role, port, base_ts=1_700_000_000_000_000, n=6):
    evs = []
    for seq in range(1, n + 1):
        typ = rng.choice(EVENT_TYPES)
        evs.append({"seq": seq, "ts_us": base_ts + seq * 1_250_000
                    + rng.randrange(0, 1000),
                    "severity": rng.choice(("info", "warn", "error")),
                    "type": typ,
                    "key": rng.choice(("request_p99_ms", "disk_fill_pct",
                                       "M00/00/01/f0001")),
                    "detail": rng.choice(("", "ewma=1200 threshold=1000",
                                          "bytes=4096"))})
    return {"role": role, "port": port, "events": evs}


def history(rng, role, n=5, restart_at=None, base_ts=1_700_000_000_000_000):
    snaps = []
    for i in range(n):
        step = 1 + i if restart_at is None or i < restart_at else 1
        reg = registry(random.Random(rng.random()), role, step)
        reg["ts_us"] = base_ts + i * 5_000_000 + rng.randrange(0, 999)
        snaps.append(reg)
    return {"snapshots": snaps}


def heat(rng, n=4):
    entries = []
    hits = sorted((rng.randrange(1, 5000) for _ in range(n)), reverse=True)
    for i, h in enumerate(hits):
        entries.append({"key": f"{GROUP}/M00/00/0{i}/f{i:04d}.bin",
                        "hits": h, "err_bound": rng.randrange(0, 20),
                        "bytes": h * rng.randrange(1000, 70_000),
                        "err": rng.randrange(0, 3),
                        "ops": {"download": {"count": h, "bytes": h * 4096},
                                "upload": {"count": rng.randrange(0, 2),
                                           "bytes": 0}}})
    return {"entries": entries}


def hot_map_body(rng, full=True):
    out = [_I64.pack(rng.randrange(1, 99)), bytes([int(full)])]
    keys = [f"{GROUP}/M00/00/0{i}/f{i:04d}.bin" for i in range(3)]
    out.append(_I64.pack(len(keys)))
    for i, key in enumerate(keys):
        groups = [f"group{j + 2}" for j in range(i)]
        out += [_I64.pack(len(key)), key.encode(), _I64.pack(len(groups))]
        out += [_g16(g) for g in groups]
    return b"".join(out)


def profile(rng, role="storage", port=23000):
    counts = sorted((rng.randrange(1, 500) for _ in range(4)), reverse=True)
    stacks = ["nio.loop;main;serve;recv", "dio.worker/1;run;write",
              "dio.worker/1;run;fsync", "sync.peer/127.0.0.9;ship"]
    return {"role": role, "port": port, "active": False, "hz": 97,
            "duration_s": 5, "samples": sum(counts),
            "dropped": rng.choice((0, 0, 7)), "overhead_us": 1234,
            "max_frames": 32,
            "stacks": [{"stack": s, "count": c}
                       for s, c in zip(stacks, counts)]}


def health_status(rng, port=23000):
    peers = []
    for addr in ("127.0.0.8:23001", "127.0.0.9:23001"):
        for op in ("fetch", "sync"):
            peers.append({"addr": addr, "op": op,
                          "score": rng.randrange(0, 101),
                          "rpc_ewma_us": rng.randrange(50, 90_000),
                          "error_pct": rng.randrange(0, 30),
                          "timeout_pct": rng.randrange(0, 10),
                          "ops": rng.randrange(0, 900),
                          "errors": rng.randrange(0, 9),
                          "timeouts": rng.randrange(0, 4),
                          "age_s": rng.randrange(0, 60)})
    return {"role": "storage", "port": port, "score": rng.randrange(0, 101),
            "stalled_threads": rng.randrange(0, 3),
            "probe": {"read_us": rng.randrange(10, 9000),
                      "write_us": rng.randrange(10, 9000),
                      "threshold_ms": 1000},
            "peers": peers}


def health_matrix(rng, addrs):
    nodes = []
    for addr in addrs:
        nodes.append({"group": GROUP, "addr": addr,
                      "self": rng.choice((-1, rng.randrange(0, 101))),
                      "peer_avg": rng.choice((-1, rng.randrange(0, 101))),
                      "reports": rng.randrange(0, 5),
                      "verdict": rng.choice(("ok", "gray", "sick",
                                             "unknown")),
                      "age_s": rng.choice((-1, rng.randrange(0, 30))),
                      "peers": {a: rng.randrange(0, 101) for a in addrs
                                if a != addr}})
    return {"role": "tracker", "port": 22122, "gray_threshold": 60,
            "nodes": nodes}


def admission(rng, role="storage", port=23000):
    level = rng.randrange(0, 4)
    return {"role": role, "port": port, "enabled": rng.random() < 0.8,
            "level": level, "level_name": R_mon.ADMISSION_LEVELS[level],
            "pressure": round(rng.random(), 3),
            "ewma": round(rng.random(), 3), "tighten_threshold": 0.85,
            "relax_threshold": 0.6, "tightens": rng.randrange(0, 9),
            "relaxes": rng.randrange(0, 9),
            "retry_after_ms": rng.randrange(0, 500),
            "admitted": rng.randrange(0, 10_000),
            "shed": rng.randrange(0, 100),
            "shed_by_class": {c: rng.randrange(0, 30)
                              for c in ("bulk", "background", "normal")}}


def storage_entry(rng, ip, port, as_list=False):
    stats = {f: rng.randrange(0, 1000) for f in R_mon.BEAT_STAT_FIELDS}
    return {"ip": ip, "port": port, "status": 7, "status_name": "ACTIVE",
            "beat_age_s": rng.randrange(0, 5),
            "free_mb": rng.randrange(1000, 9000), "total_mb": 10_000,
            "stats": ([stats[f] for f in R_mon.BEAT_STAT_FIELDS][:20]
                      if as_list else stats)}


def cluster(rng, storages, state="active"):
    """A SERVER_CLUSTER_STAT dump over ``storages``: (ip, port) pairs."""
    return {"now": 1_700_000_000,
            "tracker": {"leader": "127.0.0.1:22122", "am_leader": True,
                        "groups": 1},
            "groups": [{"name": GROUP, "members": len(storages),
                        "active": len(storages), "free_mb": 5000,
                        "trunk_server": "", "state": state,
                        "storages": [storage_entry(rng, ip, port,
                                                   as_list=i == 1)
                                     for i, (ip, port)
                                     in enumerate(storages)]}]}


SLO_CONF = """# overrides
request_p99_ms_threshold = 700ms
sync_lag_s_clear = 400
disk_fill_pct_enabled = off
error_rate_pct_threshold = 12%
bogus line
"""


# ---------------------------------------------------------------------------
# monitor: decoders, math and renderers
# ---------------------------------------------------------------------------

def norm(x):
    """Results comparable across the two packages: a dataclass becomes
    its class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    return x


def outcome(fn):
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("raised", type(e).__name__, str(e))


def top_samples(M, rng):
    """Two fdfs_top polls of a tracker and two storages (the second
    storage down in the first poll, restarted in the second)."""
    seed = rng.random()
    samples = []
    for i, ts in enumerate((1_700_000_000.0, 1_700_000_002.5)):
        r = random.Random(seed)
        s = M.TopSample(ts=ts)
        s.nodes["tracker 127.0.0.1:22122"] = M.NodeSample(
            role="tracker", addr="127.0.0.1:22122",
            registry=M.decode_registry(registry(r, "tracker", 1 + i)))
        s.nodes["storage 127.0.0.1:23000"] = M.NodeSample(
            role="storage", addr="127.0.0.1:23000",
            registry=M.decode_registry(registry(r, "storage", 1 + 3 * i)))
        s.nodes["storage 127.0.0.2:23000"] = (
            M.NodeSample(role="storage", addr="127.0.0.2:23000",
                         error="ConnectionRefusedError: refused")
            if i == 0 else
            M.NodeSample(role="storage", addr="127.0.0.2:23000",
                         registry=M.decode_registry(
                             registry(r, "storage", 1))))
        s.events = M.decode_events(events(r, "storage", 23000),
                                   "storage 127.0.0.1:23000")
        s.cluster = cluster(r, [("127.0.0.1", 23000), ("127.0.0.2", 23000)],
                            state="draining" if i else "active")
        samples.append(s)
    return samples


def snapshot(M, rng):
    cs = cluster(rng, [("127.0.0.1", 23000), ("127.0.0.2", 23000)],
                 state=rng.choice(("active", "draining")))
    snap = M.ClusterSnapshot(now=cs["now"], tracker=cs["tracker"],
                             groups=cs["groups"])
    snap.storage_stats["127.0.0.1:23000"] = M.decode_registry(
        registry(rng, "storage", 3))
    snap.storage_errors["127.0.0.2:23000"] = "TimeoutError: timed out"
    return snap


def report_data(M, rng):
    data = M.ReportData(since_us=1_700_000_004_000_000)
    for node, role, restart in (("tracker 127.0.0.1:22122", "tracker", None),
                                ("storage 127.0.0.1:23000", "storage", 3)):
        data.history[node] = M.decode_metrics_history(
            history(rng, role, restart_at=restart))
        data.events[node] = M.decode_events(
            events(rng, role, 23000, base_ts=1_700_000_012_000_000), node)
    data.heat["storage 127.0.0.1:23000"] = M.decode_heat(heat(rng))
    data.errors["storage 127.0.0.2:23000"] = "no metrics journal (ENOTSUP)"
    return data


def _rates(M, rng):
    prev, cur = top_samples(M, rng)
    return M.top_rates(None, prev), M.top_rates(prev, cur)


def _render_top(M, rng):
    prev, cur = top_samples(M, rng)
    rates = M.top_rates(prev, cur)
    hm = M.decode_hot_map(hot_map_body(rng))
    heat_panes = {"storage 127.0.0.1:23000": M.decode_heat(heat(rng)),
                  "storage 127.0.0.2:23000": []}
    threads = {n: M.thread_ledger(s.registry)
               for n, s in cur.nodes.items() if s.registry is not None}
    return (M.render_top(cur, rates, prev.events + cur.events, 4,
                         alerts={"storage 127.0.0.1:23000":
                                 ["request_p99_ms"]},
                         heat=heat_panes, heat_rows=2, threads=threads,
                         thread_rows=2, hot_map=hm),
            M.render_top(prev, M.top_rates(None, prev), []))


def _history_series(M, rng):
    hist = M.decode_metrics_history(history(rng, "storage", restart_at=2))
    return M.report_series(hist)


def _timeline(M, rng):
    data = report_data(M, rng)
    return M.breach_timeline(data.events, data.since_us, data.history)


def _hist_math(M, rng):
    prev, cur = _hist(rng, 20), _hist(rng, 60)
    cur["counts"] = [a + b for a, b in zip(prev["counts"], cur["counts"])]
    cur["count"] = sum(cur["counts"])
    cur["sum"] += prev["sum"]
    d = M.hist_delta(prev, cur)
    return (d, M.hist_delta(None, cur), M.hist_delta(cur, prev),
            [M.hist_quantile(d, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            M.hist_quantile({"bounds": [], "counts": []}, 0.5))


MONITOR_CASES = {
    "beat_stats": lambda M, rng: (
        M.beat_stats([rng.randrange(0, 99) for _ in range(7)]),
        M.beat_stats(list(range(M.BEAT_STAT_COUNT + 3)))),
    "beat_stats_from_storage": lambda M, rng: [
        M.beat_stats_from_storage(storage_entry(rng, "127.0.0.1", 1, lst))
        for lst in (False, True)],
    "decode_registry": lambda M, rng: M.decode_registry(
        registry(rng, rng.choice(("tracker", "storage")))),
    "decode_events": lambda M, rng: (
        M.decode_events(events(rng, "storage", 23000)),
        M.decode_events(events(rng, "tracker", 22122), "tracker x")),
    "decode_metrics_history": lambda M, rng: M.decode_metrics_history(
        history(rng, "storage")),
    "decode_heat": lambda M, rng: M.decode_heat(heat(rng)),
    "decode_hot_map": lambda M, rng: (
        M.decode_hot_map(hot_map_body(rng)),
        M.decode_hot_map(hot_map_body(rng, full=False))),
    "decode_profile": lambda M, rng: M.decode_profile(profile(rng)),
    "render_folded": lambda M, rng: M.render_folded(
        M.decode_profile(profile(rng))),
    "thread_ledger": lambda M, rng: M.thread_ledger(
        registry(rng, "storage")),
    "decode_health_status": lambda M, rng: M.decode_health_status(
        health_status(rng)),
    "decode_health_matrix": lambda M, rng: M.decode_health_matrix(
        health_matrix(rng, ["127.0.0.1:23000", "127.0.0.2:23000"])),
    "decode_admission": lambda M, rng: M.decode_admission(admission(rng)),
    "parse_slo_rules": lambda M, rng: (M.parse_slo_rules(SLO_CONF),
                                       M.parse_slo_rules("")),
    "hist_math": _hist_math,
    "top_rates": _rates,
    "render_top": _render_top,
    "render_text": lambda M, rng: M.render_text(snapshot(M, rng)),
    "to_prometheus": lambda M, rng: M.to_prometheus(snapshot(M, rng)),
    "report_series": _history_series,
    "breach_timeline": _timeline,
    "render_report": lambda M, rng: M.render_report(report_data(M, rng),
                                                    max_rows=3,
                                                    heat_rows=2),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_equals_reference(case, seed):
    ref = outcome(lambda: MONITOR_CASES[case](R_mon, random.Random(seed)))
    got = outcome(lambda: MONITOR_CASES[case](T_mon, random.Random(seed)))
    assert ref[0] == "ok", ref
    assert got == ref


def _bad_registry():
    reg = registry(random.Random(5), "storage")
    h = reg["histograms"]["nio.loop_lag_us"]
    return [[1, 2], {"counters": {"a": "1"}},
            {"histograms": {"x": dict(h, counts=h["counts"][:-1])}},
            {"histograms": {"x": dict(h, count=h["count"] + 1)}}]


MALFORMED = [
    ("decode_registry", b) for b in _bad_registry()] + [
    ("decode_events", {"events": None}),
    ("decode_events", {"events": [{"seq": 1, "ts_us": 2, "severity": "fatal",
                                   "type": "t", "key": "k"}]}),
    ("decode_events", {"events": [{"seq": "x"}]}),
    ("decode_metrics_history", {"snapshots": [{"ts_us": "late"}]}),
    ("decode_metrics_history", []),
    ("decode_heat", {"entries": [{"key": "a", "hits": 1},
                                 {"key": "b", "hits": 5}]}),
    ("decode_heat", {"entries": [{"hits": 1}]}),
    ("decode_hot_map", b"\0" * 16),
    ("decode_hot_map", hot_map_body(random.Random(1))[:-5]),
    ("decode_hot_map", _I64.pack(1) + b"\1" + _I64.pack(1) + _I64.pack(-3)),
    ("decode_profile", {"stacks": [{"stack": "a", "count": 1},
                                   {"stack": "b", "count": 2}]}),
    ("decode_profile", {"stacks": []}),
    ("decode_health_status", {"peers": [{"addr": "b", "op": "x"}]}),
    ("decode_health_status", {"peers": []}),
    ("decode_health_matrix", {"nodes": [{"verdict": "green"}]}),
    ("decode_health_matrix", {"nodes": []}),
    ("decode_admission", {"level": 1, "level_name": "admit-all"}),
    ("decode_admission", dict(admission(random.Random(2)), level=9)),
    ("decode_admission", dict(admission(random.Random(3)),
                              shed_by_class={"vip": 1})),
]


@pytest.mark.parametrize("idx", range(len(MALFORMED)))
def test_monitor_rejects_malformed_input_as_the_reference(idx):
    name, blob = MALFORMED[idx]
    ref = outcome(lambda: getattr(R_mon, name)(blob))
    got = outcome(lambda: getattr(T_mon, name)(blob))
    assert ref[0] == "raised", ref
    assert got == ref


# ---------------------------------------------------------------------------
# CLI: every tool over scripted fake daemons
# ---------------------------------------------------------------------------

class MonitorStorage(FakeStorage):
    """A fake storage that also answers the monitor's opcodes with the
    seeded blobs."""

    def __init__(self, seed, **kw):
        super().__init__(**kw)
        self.seed = seed

    def answer(self, cmd, body):
        rng = random.Random(self.seed * 100 + cmd)
        blobs = {
            130: lambda: registry(rng, "storage", 2),
            131: lambda: spans_dump(rng, "storage", 23000),
            137: lambda: events(rng, "storage", 23000),
            138: lambda: history(rng, "storage"),
            139: lambda: heat(rng),
            141: lambda: {"active": body[:1] == b"\1", "hz": 89},
            142: lambda: profile(rng),
            146: lambda: health_status(rng),
            148: lambda: admission(rng),
        }
        if cmd in blobs:
            return 0, json.dumps(blobs[cmd]()).encode()
        return super().answer(cmd, body)


class MonitorTracker(FakeTracker):
    """A fake tracker whose cluster dump lists its storages and which
    answers the monitor's opcodes with the seeded blobs."""

    def __init__(self, storages, seed, state="active", **kw):
        super().__init__(storages, **kw)
        self.seed = seed
        self.state = state

    def answer(self, cmd, body):
        rng = random.Random(self.seed * 100 + cmd)
        addrs = [("127.0.0.1", s.port) for s in self.storages]
        blobs = {
            95: lambda: cluster(rng, addrs, self.state),
            96: lambda: spans_dump(rng, "tracker", 22122),
            97: lambda: registry(rng, "tracker", 2),
            98: lambda: events(rng, "tracker", 22122),
            99: lambda: history(rng, "tracker"),
            67: lambda: {"active": body[:1] == b"\1", "hz": 97},
            68: lambda: profile(rng, "tracker", 22122),
            69: lambda: health_matrix(rng, [f"{ip}:{p}" for ip, p in addrs]),
            148: lambda: admission(rng, "tracker", 22122),
        }
        if cmd in blobs:
            return 0, json.dumps(blobs[cmd]()).encode()
        return super().answer(cmd, body)


def spans_dump(rng, role, port):
    t0 = 1_700_000_000_000_000
    spans = [{"trace_id": f"{TRACE_ID:016x}", "span_id": f"{0x80000001 + i:08x}",
              "parent_id": f"{0x80000001 + i - 1:08x}" if i else "00000000",
              "name": f"{role}.op{i}", "start_us": t0 + 100 * i,
              "dur_us": rng.randrange(10, 900), "status": 0,
              "flags": rng.choice((1, 3))} for i in range(3)]
    return {"role": role, "port": port, "spans": spans}


def real_file_id(data):
    """A decodable file ID for ``file_info`` (the fakes' own names are
    not)."""
    return encode_file_id(GROUP, 0, "127.0.0.1", 1_700_000_000, len(data),
                          0x1234ABCD, ext="bin")


def cluster_of(seed, state="active", placement=True, hot=True):
    """One storage holding a real file ID and a tracker routing to it."""
    def build():
        st = MonitorStorage(seed)
        data = b"seeded payload " * 40
        fid = real_file_id(data)
        st.files[fid.split("/", 1)[1]] = data
        tr = MonitorTracker(
            [st], seed, state,
            placement=[(GROUP, 1 if state != "active" else 0, [st])]
            if placement else None,
            hot={f"{GROUP}/M00/00/01/f0001.bin": ["group2", "group3"]}
            if hot else None)
        return st, tr, fid
    return build


_TIME = re.compile(r"\b\d\d:\d\d:\d\d\b")
_DUR = re.compile(r"[+]?\d+\.\d\dms")
_HEX16 = re.compile(r"\b[0-9a-f]{16}\b")
_BAR = re.compile(r"\|[# ]{24}\|")


def _masked(text, servers, volatile):
    for i, s in enumerate(servers):
        text = text.replace(f":{s.port}", f":{s.role}{i}")
        text = re.sub(rf"(\"port\": ){s.port}\b", rf"\g<1>{s.role}{i}", text)
    if volatile:
        text = _TIME.sub("<hh:mm:ss>", text)
        text = _DUR.sub("<ms>", text)
        text = _HEX16.sub("<id>", text)
        text = _BAR.sub("|<bar>|", text)
        text = re.sub(r'"ts": [0-9.]+', '"ts": <ts>', text)
        text = re.sub(r'"(start|dur)_us": \d+', r'"\1_us": <us>', text)
        text = re.sub(r'"span_id": "[0-9a-f]{8}"', '"span_id": <id>', text)
    return text


def run_cli(main, prefix, argv, build, tmp_path, volatile):
    """``main(prefix + argv)`` over fresh fakes; ``{tracker}``, ``{fid}``
    and ``{tmp}`` in ``argv`` name the tracker, the seeded file ID and
    the test's scratch directory."""
    st, tr, fid = build()
    servers = [st, tr]
    try:
        args = [a.format(tracker=f"127.0.0.1:{tr.port}", fid=fid,
                         tmp=str(tmp_path), storage=f"127.0.0.1:{st.port}",
                         tracker_port=tr.port)
                for a in argv]
        out, err = io.StringIO(), io.StringIO()
        random.seed(1234)
        # ``test`` and ``trace`` upload random payloads: the same ones.
        urandom, os.urandom = os.urandom, random.Random(99).randbytes
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(prefix + args)
        finally:
            os.urandom = urandom
    finally:
        for s in servers:
            s.close()
    frames = [[(c, b) for _, c, b in s.frames] for s in servers]
    if volatile:  # trace ids ride the TRACE_CTX frames
        frames = [[(c, b) for c, b in f if c != 140] for f in frames]
    return (rc, _masked(out.getvalue(), servers, volatile),
            _masked(err.getvalue(), servers, volatile), frames)


def _write(tmp_path, name, data):
    path = os.path.join(str(tmp_path), name)
    with open(path, "wb") as fh:
        fh.write(data)
    return path


PAYLOAD = bytes(random.Random(7).randrange(256) for _ in range(150_000))

# (id, argv, fake cluster builder kwargs, volatile output)
CLI_CASES = [
    ("upload", ["upload", "{tracker}", "{tmp}/payload.bin"], {}, False),
    ("upload_ext", ["upload", "{tracker}", "{tmp}/payload.bin", "dat"], {},
     False),
    ("upload_dedup", ["upload", "{tracker}", "--dedup", "{tmp}/payload.bin"],
     {}, False),
    ("upload_usage", ["upload", "{tracker}"], {}, False),
    ("upload_dedup_usage", ["upload", "{tracker}", "--dedup"], {}, False),
    ("upload_missing_file", ["upload", "{tracker}", "{tmp}/absent"], {},
     False),
    ("download", ["download", "{tracker}", "{fid}", "{tmp}/out.bin"], {},
     False),
    ("download_parallel", ["download", "{tracker}", "--parallel", "2",
                           "{fid}", "{tmp}/out.bin"], {}, False),
    ("download_bad_parallel", ["download", "{tracker}", "--parallel", "x"],
     {}, False),
    ("download_missing", ["download", "{tracker}", "group1/M00/00/00/none",
                          "{tmp}/out.bin"], {}, False),
    ("delete", ["delete", "{tracker}", "{fid}"], {}, False),
    ("delete_usage", ["delete", "{tracker}"], {}, False),
    ("file_info", ["file_info", "{tracker}", "{fid}"], {}, False),
    ("file_info_bad_id", ["file_info", "{tracker}", "group1/M00/zz"], {},
     False),
    ("monitor", ["monitor", "{tracker}"], {}, False),
    ("monitor_prometheus", ["monitor", "{tracker}", "--prometheus"], {},
     False),
    ("monitor_no_stats", ["monitor", "{tracker}", "--no-storage-stats",
                          "--group", "group1"], {}, False),
    ("monitor_draining", ["monitor", "{tracker}"], {"state": "draining"},
     False),
    ("monitor_group_usage", ["monitor", "{tracker}", "--group"], {}, False),
    ("top", ["top", "{tracker}", "--count", "1", "--heat", "3",
             "--threads", "2", "--events", "4"], {}, True),
    ("top_json", ["top", "{tracker}", "--count", "1", "--json", "--heat",
                  "--threads"], {}, True),
    ("top_no_hot_map", ["top", "{tracker}", "--count", "1"],
     {"hot": False, "state": "draining"}, True),
    ("report", ["report", "{tracker}", "--rows", "3", "--heat-k", "2"], {},
     False),
    ("report_json", ["report", "{tracker}", "--json", "--since",
                     "1700000000"], {}, False),
    ("report_bad_since", ["report", "{tracker}", "--since", "-5"], {},
     False),
    ("test", ["test", "{tracker}"], {}, False),
    ("groups_json", ["groups_json", "{tracker}"], {}, False),
    ("append", ["append", "{tracker}", "{fid}", "{tmp}/payload.bin"], {},
     False),
    ("append_usage", ["append", "{tracker}", "{fid}"], {}, False),
    ("upload_appender", ["upload_appender", "{tracker}", "{tmp}/payload.bin"],
     {}, False),
    ("upload_appender_usage", ["upload_appender", "{tracker}"], {}, False),
    ("delete_server", ["delete_server", "{tracker}", "group1",
                       "127.0.0.1:23000"], {}, False),
    ("delete_server_usage", ["delete_server", "{tracker}", "group1"], {},
     False),
    ("set_trunk_server", ["set_trunk_server", "{tracker}", "group1",
                          "127.0.0.1:23000"], {}, False),
    ("set_trunk_server_usage", ["set_trunk_server", "{tracker}"], {}, False),
    ("tracker_status", ["tracker_status", "{tracker}"], {}, False),
    ("near_dups", ["near_dups", "{tracker}", "{fid}"], {}, False),
    ("near_dups_usage", ["near_dups", "{tracker}"], {}, False),
    ("trace_id", ["trace", "{tracker}", "--trace-id", f"{TRACE_ID:x}"], {},
     False),
    ("trace_id_json", ["trace", "{tracker}", "--trace-id", f"{TRACE_ID:x}",
                       "--json"], {}, False),
    ("trace_upload", ["trace", "{tracker}", "--size", "3000", "--wait", "0"],
     {}, True),
    ("trace_file", ["trace", "{tracker}", "--file", "{tmp}/payload.bin",
                    "--wait", "0", "--json"], {}, True),
    ("profile_dump", ["profile", "{tracker}", "{storage}", "--dump-only"],
     {}, False),
    ("profile_json", ["profile", "{tracker}", "{storage}", "--dump-only",
                      "--json"], {}, False),
    ("profile_arm", ["profile", "{tracker}", "{storage}", "--hz", "50",
                     "--seconds", "3", "--no-wait"], {}, False),
    ("profile_stop", ["profile", "{tracker}", "{storage}", "--stop"], {},
     False),
    ("profile_tracker", ["profile", "{tracker}", "127.0.0.1:{tracker_port}",
                         "--tracker", "--dump-only"], {}, False),
    ("profile_usage", ["profile", "{tracker}", "--json"], {}, False),
    ("scrub", ["scrub", "{tracker}"], {}, False),
    ("scrub_json_kick", ["scrub", "{tracker}", "--kick", "--json"], {},
     False),
    ("scrub_usage", ["scrub", "{tracker}", "--group"], {}, False),
    ("ec", ["ec", "{tracker}"], {}, False),
    ("ec_json_kick", ["ec", "{tracker}", "--kick", "--json"], {}, False),
    ("ec_usage", ["ec", "{tracker}", "--group", "--json"], {}, False),
    ("health", ["health", "{tracker}"], {}, False),
    ("health_detail", ["health", "{tracker}", "--detail"], {}, False),
    ("health_json", ["health", "{tracker}", "--detail", "--json"], {},
     False),
    ("admission", ["admission", "{tracker}"], {}, False),
    ("admission_json", ["admission", "{tracker}", "--json"], {}, False),
    ("group_status", ["group", "{tracker}", "status"], {"state": "draining"},
     False),
    ("group_status_json", ["group", "{tracker}", "status", "--json"], {},
     False),
    ("group_no_placement", ["group", "{tracker}", "status"],
     {"placement": False}, False),
    ("group_drain", ["group", "{tracker}", "drain", "group1"], {}, False),
    ("group_reactivate", ["group", "{tracker}", "reactivate", "group1"], {},
     False),
    ("group_usage", ["group", "{tracker}"], {}, False),
    ("group_bad_verb", ["group", "{tracker}", "rename"], {}, False),
    ("group_drain_usage", ["group", "{tracker}", "drain", "--json"], {},
     False),
    ("hot", ["hot", "{tracker}", "--rows", "2"], {}, False),
    ("hot_json", ["hot", "{tracker}", "--json"], {}, False),
    ("hot_no_map", ["hot", "{tracker}"], {"hot": False}, False),
    ("no_tool", ["{tracker}"], {}, False),
    ("unknown_tool", ["fsck", "{tracker}"], {}, False),
    ("dead_tracker", ["monitor", "127.0.0.1:1"], {}, False),
]


_USAGE = {
    "reference": "usage: python -m fastdfs_tpu.cli <",
    "port": "usage: python -m fastdfs_tpu_torch.cli [--device cuda|cpu] <",
}


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("name,argv,kw,volatile", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_cli_tool_equals_reference(name, argv, kw, volatile, seed,
                                   tmp_path):
    _write(tmp_path, "payload.bin", PAYLOAD[:100_000 + 5000 * seed])
    build = cluster_of(seed, **kw)
    ref = run_cli(R_cli.main, [], argv, build, tmp_path, volatile)
    got = run_cli(T_cli.main, ["--device", "cpu"], argv, build, tmp_path,
                  volatile)
    # The usage line names the module (and the port's device flag).
    got = (got[0], got[1], got[2].replace(_USAGE["port"],
                                          _USAGE["reference"]), got[3])
    assert got[:3] == ref[:3]
    assert got[3] == ref[3]


def test_cli_usage_names_the_device_flag(capsys):
    assert T_cli.main(["--device", "cpu"]) == 2
    assert T_cli.main(["--device"]) == 2
    assert T_cli.main([]) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 3 and all(line.startswith(_USAGE["port"])
                                 for line in err)
    assert set(T_cli.TOOLS) == set(R_cli.TOOLS)


@pytest.mark.parametrize("prefix", ([], ["--device", "cuda"]))
def test_cli_cuda_without_a_card_raises_before_any_socket(prefix):
    """The default device is the card; without one the CLI raises
    instead of answering from the CPU, and opens no connection."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    st, tr, _ = cluster_of(0)()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T_cli.main(prefix + ["upload", f"127.0.0.1:{tr.port}",
                                 "--dedup", __file__])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T_cli.main(prefix + ["monitor", f"127.0.0.1:{tr.port}"])
    finally:
        st.close()
        tr.close()
    assert tr.conns == 0 and st.conns == 0


def test_cli_rejects_an_unknown_device():
    with pytest.raises(ValueError, match="unsupported device"):
        T_cli.main(["--device", "meta", "monitor", "127.0.0.1:1"])


@pytest.mark.parametrize("sampler", ("gather", "gather_top",
                                     "gather_report"))
def test_monitor_sample_on_cpu_has_live_storage_rows(sampler):
    """The port's sampler opens each storage on the client's device: on
    the CPU a live storage is a live row, never an error row."""
    st, tr, _ = cluster_of(0)()
    c = T_client.FdfsClient([f"127.0.0.1:{tr.port}"], timeout=5.0,
                            device="cpu")
    try:
        sample = getattr(T_mon, sampler)(c)
    finally:
        c.close()
        st.close()
        tr.close()
    addr = f"127.0.0.1:{st.port}"
    if sampler == "gather":
        assert sample.storage_errors == {}
        assert addr in sample.storage_stats
    elif sampler == "gather_top":
        node = sample.nodes[f"storage {addr}"]
        assert node.error == "" and node.registry is not None
        assert not [n for n in sample.nodes.values() if n.error]
    else:
        assert sample.errors == {}
        assert f"storage {addr}" in sample.history
