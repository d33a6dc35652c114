"""The port's ``trace.py`` against the reference's: context framing,
``decode_dump``, ``stitch``, ``render_timeline`` and ``spans_to_json`` on
seeded span dumps, and ``Tracer`` / ``traced_upload`` /
``collect_cluster_spans`` over the port's client against scripted fake
daemons.  Tolerance: exact equality (bytes, spans, rendered text)."""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from fastdfs_tpu import trace as R
from fastdfs_tpu_torch import trace as T
from tests.test_torch_client_wire import (FakeStorage, FakeTracker, GROUP,
                                          run_both)

SEEDS = range(6)


def _dump(rng, role="storage", port=23000, n=12, traces=3):
    """A seeded TRACE_DUMP object: spans of a few traces, each a tree with
    some orphans, a self-parented span, SLOW flags and error statuses."""
    tids = [int(t) for t in rng.integers(1, 1 << 62, traces)]
    spans = []
    ids = [int(i) for i in rng.integers(1, 1 << 31, n)]
    for i, sid in enumerate(ids):
        r = int(rng.integers(0, 10))
        parent = (0 if r < 2 else sid if r == 2
                  else int(rng.integers(1, 1 << 31)) if r == 3
                  else ids[int(rng.integers(0, n))])
        spans.append({
            "trace_id": f"{tids[i % traces]:016x}",
            "span_id": f"{sid:08x}", "parent_id": f"{parent:08x}",
            "name": ["nio.recv", "storage.upload", "fingerprint",
                     "chunkstore.write", "binlog.append"][i % 5],
            "start_us": int(rng.integers(1_700_000_000_000_000,
                                         1_700_000_000_100_000)),
            "dur_us": int(rng.integers(0, 50_000)),
            "status": int(rng.choice([0, 0, 0, 2, 5])),
            "flags": int(rng.integers(0, 4))})
    return {"role": role, "port": port, "spans": spans}


def _astuples(spans):
    return [dataclasses.astuple(s) for s in spans]


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_ctx_frames_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        tid = int(rng.integers(0, 1 << 63)) * 2 + 1
        sid, flags = int(rng.integers(0, 1 << 32)), int(rng.integers(0, 4))
        frame = T.TraceContext(tid, sid, flags).frame()
        assert frame == R.TraceContext(tid, sid, flags).frame()
        got = T.TraceContext.unpack(frame[10:])
        want = R.TraceContext.unpack(frame[10:])
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_dump_equals_reference(seed):
    obj = _dump(np.random.default_rng(seed))
    for node in ("", "storage 127.0.0.1:23000"):
        assert (_astuples(T.decode_dump(obj, node))
                == _astuples(R.decode_dump(obj, node)))


@pytest.mark.parametrize("bad", [
    [], {"spans": None}, {"spans": [{"trace_id": "zz"}]},
    {"spans": [{"trace_id": "1", "span_id": "2", "parent_id": "0",
                "name": "x", "start_us": "later", "dur_us": 1}]},
    {"spans": [{"span_id": "2"}]}, {"role": "tracker"}])
def test_decode_dump_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        R.decode_dump(bad)
    with pytest.raises(ValueError) as got:
        T.decode_dump(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_stitch_render_and_json_equal_reference(seed):
    rng = np.random.default_rng(100 + seed)
    dumps = [_dump(rng, "tracker", 22122, n=8),
             _dump(rng, "storage", 23000, n=16)]
    ref = [s for d in dumps for s in R.decode_dump(d)]
    port = [s for d in dumps for s in T.decode_dump(d)]
    want = R.stitch(ref)
    got = T.stitch(port)
    assert sorted(got) == sorted(want)
    assert all(_astuples(got[k]) == _astuples(want[k]) for k in want)
    assert T.render_timeline(port) == R.render_timeline(ref)
    tid = sorted(want)[0]
    assert T.render_timeline(port, tid) == R.render_timeline(ref, tid)
    assert T.render_timeline(port, 12345) == R.render_timeline(ref, 12345)
    assert T.spans_to_json(port) == R.spans_to_json(ref)


def test_tracer_nesting_equals_reference(monkeypatch):
    out = {}
    for name, mod in (("reference", R), ("port", T)):
        ids = itertools.count(11)
        clock = itertools.count(1_000_000, 250)
        monkeypatch.setattr(mod, "_new_trace_id", lambda: 0xABCDEF)
        monkeypatch.setattr(mod, "_new_span_id", lambda: next(ids))
        monkeypatch.setattr(mod.time, "time", lambda: next(clock) / 1e6)
        tr = mod.Tracer(flags=mod.TRACE_FLAG_SAMPLED | mod.TRACE_FLAG_SLOW)
        ctxs = [tr.wire_ctx()]
        with tr.span("outer") as a:
            ctxs.append(tr.wire_ctx())
            with tr.span("inner") as b:
                ctxs.append(tr.wire_ctx())
            ctxs += [a, b, tr.wire_ctx()]
        ctxs.append(tr.wire_ctx())
        out[name] = ([None if c is None else dataclasses.astuple(c)
                      for c in ctxs], _astuples(tr.spans),
                     T.render_timeline(tr.spans) if mod is T
                     else R.render_timeline(tr.spans))
        monkeypatch.undo()
    assert out["port"] == out["reference"]


class TracingTracker(FakeTracker):
    """Answers TRACE_DUMP and SERVER_CLUSTER_STAT with seeded dumps."""

    def __init__(self, storages, dump):
        super().__init__(storages)
        self.dump = dump

    def answer(self, cmd, body):
        if cmd == 96:
            return 0, json.dumps(self.dump).encode()
        if cmd == 95:
            return 0, json.dumps({"groups": [{"group": GROUP, "storages": [
                {"ip": "127.0.0.1", "port": s.port}
                for s in self.storages]}]}).encode()
        return super().answer(cmd, body)


class TracingStorage(FakeStorage):
    def __init__(self, dump):
        super().__init__()
        self.dump = dump

    def answer(self, cmd, body):
        if cmd == 131:
            return 0, json.dumps(self.dump).encode()
        return super().answer(cmd, body)


def _traced(env, mp):
    trace = R if env.side["client"].__name__.startswith("fastdfs_tpu.") else T
    ids = itertools.count(21)
    clock = itertools.count(2_000_000, 125)
    mp.setattr(trace, "_new_trace_id", lambda: 0x1234)
    mp.setattr(trace, "_new_span_id", lambda: next(ids))
    mp.setattr(trace.time, "time", lambda: next(clock) / 1e6)
    rng = np.random.default_rng(7)
    st = env.add(TracingStorage(_dump(rng, "storage", 23000)))
    tr = env.add(TracingTracker([st], _dump(rng, "tracker", 22122)))
    cli = env.fdfs([tr, f"127.0.0.1:{tr.port + 0}"])
    try:
        fid, tracer = trace.traced_upload(cli, b"traced" * 1000, ext="bin")
        env.out.append(fid)
        env.out.append(_astuples(tracer.spans))
        env.out.append(cli.tracer is None)
        env.rec(cli.upload_buffer, b"untraced")
        with tracer.span("client.read"):
            cli.tracer = tracer
            env.rec(cli.download_to_buffer, fid)
        cli.tracer = None
        spans, errors = trace.collect_cluster_spans(cli)
        env.out.append((_astuples(spans), errors))
        env.out.append(trace.render_timeline(spans + tracer.spans))
    finally:
        cli.close()


def test_tracer_stamps_the_wire_context_like_the_reference(monkeypatch):
    ref, port = run_both(_traced, monkeypatch)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    storage_frames, tracker_frames = port[1]
    # The traced upload's requests carry a TRACE_CTX frame (140) with the
    # trace id and the client span's id; the untraced upload carries none.
    ctx = T.TraceContext(0x1234, 21).frame()[10:]
    assert (140, ctx) in tracker_frames and (140, ctx) in storage_frames
    cmds = [c for c, _ in storage_frames]
    assert cmds[:3] == [140, 11, 11]
