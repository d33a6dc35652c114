"""The port's in-process span ring (``fastdfs_tpu_torch.trace.SpanRing``)
and the spans ``DedupEngine.fingerprint`` writes into it on the CPU.

The ring: capacity, wrap, ``recorded`` and ``dropped`` as the daemons'
``TraceRing`` counts them, the window filter, export as ``Span``s, and a
dump that ``decode_dump`` reads and ``render_timeline`` renders.  The
engine: each call writes one root and its named children, one after
another from the root's start to its end, under one call id, whether it
is given its cuts or finds them, and threads calling at once keep their
calls apart.  The engine's
answers are held to the reference by the parity tests."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from fastdfs_tpu_torch import trace as T
from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine
from fastdfs_tpu_torch.ops import gear_cdc

GEO = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
CHILDREN = ["engine.cuts", "engine.stage_wait", "engine.stage_copy", "engine.table",
            "engine.upload", "engine.launch", "engine.copy_back",
            "engine.unpack"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _call(ring, rec, t0, children, root_dur=100):
    """Write one call by hand: children of 10 ns each from t0 + 5, the
    root from t0 to t0 + root_dur."""
    n = len(children)
    ring._record(
        T.array.array("q", [t0 + 5 + 10 * j for j in range(n)] + [t0]),
        T.array.array("q", [t0 + 15 + 10 * j for j in range(n)]
                      + [t0 + root_dur]),
        T.array.array("h", [ring.code(c) for c in children] + [rec.root]),
        rec.tids)


def _ring(capacity):
    ring = T.SpanRing(capacity)
    return ring, T.CallSpans(ring, "root")


def test_ring_is_empty_until_the_first_record():
    ring, _ = _ring(8)
    assert (ring.recorded, ring.dropped, ring.lost_until_ns) == (0, 0, 0)
    assert ring.spans() == [] and ring.dump("sidecar")["spans"] == []
    assert all(len(v) == 0 for v in ring.arrays().values())


def test_ring_counts_and_overwrites_the_oldest():
    ring, rec = _ring(10)
    for c in range(5):
        _call(ring, rec, 1000 * (c + 1), ["a", "b"])
    assert ring.recorded == 15 and ring.dropped == 5
    a = ring.arrays()
    assert a["seq"].tolist() == list(range(5, 15))
    # The overwritten: call 0 whole, and call 1's first two children.
    # The latest end among them is call 1's second child's.
    assert ring.lost_until_ns == 2000 + 25
    # Call 1's root is kept; its children are gone.
    calls = a["call"].tolist()
    assert calls == [6] + [9] * 3 + [12] * 3 + [15] * 3


def test_ring_wraps_a_call_across_its_end():
    ring, rec = _ring(10)
    for c in range(3):
        _call(ring, rec, 1000 * (c + 1), ["a", "b", "c"])
    # Third call's four spans land in slots 8, 9, 0, 1.
    a = ring.arrays()
    assert a["seq"].tolist() == list(range(2, 12))
    third = a["call"] == 12
    assert third.sum() == 4
    assert [ring.names[n] for n in a["name"][third]] == ["a", "b", "c",
                                                         "root"]
    assert a["parent_seq"][third].tolist() == [11, 11, 11, -1]
    assert a["start_ns"][third].tolist() == [3005, 3015, 3025, 3000]
    assert a["end_ns"][third].tolist() == [3015, 3025, 3035, 3100]
    assert ring.lost_until_ns == 1000 + 25   # call 1's first two children


def test_ring_window_keeps_spans_inside_it():
    ring, rec = _ring(64)
    for t in (1000, 2000, 3000):
        _call(ring, rec, t, ["a"])
    inside = ring.spans(1500, 3100)
    assert sorted((s.name, s.start_us) for s in inside) == \
        sorted([("a", 2), ("root", 2), ("a", 3), ("root", 3)])
    # A span that ends after the window's end is left out.
    assert [s.name for s in ring.spans(2900, 3050)] == ["a"]
    assert ring.arrays(since_ns=3001)["name"].tolist() == [ring.code("a")]


def test_ring_spans_are_trace_spans():
    ring, rec = _ring(64)
    _call(ring, rec, 10_000_000, ["a", "b"], root_dur=50_000)
    spans = ring.spans()
    assert [s.name for s in spans] == ["a", "b", "root"]
    root = spans[-1]
    assert (root.trace_id, root.parent_id) == (3, 0)
    assert all(s.trace_id == 3 and s.parent_id == root.span_id
               for s in spans[:2])
    assert root.start_us == 10_000 and root.dur_us == 50
    assert all(root.start_us <= s.start_us and s.end_us <= root.end_us
               for s in spans)
    assert T.stitch(spans)[3][0] is root


def test_ring_dump_decodes_and_renders():
    ring, rec = _ring(64)
    for t in (5_000_000, 9_000_000):
        _call(ring, rec, t, ["a", "b"], root_dur=40_000)
    dump = ring.dump("sidecar", newest=3)
    assert (dump["role"], dump["recorded"], dump["dropped"]) == \
        ("sidecar", 6, 0)
    got = T.decode_dump(dump)
    # One start in whole microseconds: sorted by span id, as written.
    assert [(s.trace_id, s.name) for s in got] == [(6, "a"), (6, "b"),
                                                   (6, "root")]
    want = [dataclasses.replace(s, node="sidecar:0")
            for s in ring.spans(newest=3)]
    assert sorted(got, key=lambda s: s.span_id) == want
    text = T.render_timeline(got)
    assert text.splitlines()[0].startswith("trace 0000000000000006  spans=3")
    assert [line.split("]")[1].split()[0] for line in text.splitlines()[1:]
            ] == ["root", "a", "b"]


def test_ring_refuses_marks_that_do_not_fit():
    ring, rec = _ring(8)

    def q(v=()):
        return T.array.array("q", v)

    def h(v=()):
        return T.array.array("h", v)

    for start, end, name in ((q([1, 2]), q([3]), h([0, 0])),
                             (q([1]), q([3]), h([0, 0])),
                             (q(), q(), h())):
        with pytest.raises(ValueError):
            ring._record(start, end, name, rec.tids)
    assert ring.recorded == 0


def test_recorder_reuses_its_lists():
    """The recorder reuses its two arrays of marks and codes from call to
    call, and its children run from the root's start to its end."""
    ring, rec = _ring(1 << 10)
    marks, codes = rec.marks, rec.codes
    for _ in range(3):
        rec.open()
        rec.end(ring.code("a"))
        rec.close(ring.code("b"))
    assert rec.marks is marks and rec.codes is codes
    assert ring.recorded == 9
    a = ring.arrays()
    starts = a["start_ns"].reshape(3, 3)
    ends = a["end_ns"].reshape(3, 3)
    assert (starts[:, 0] == starts[:, 2]).all()
    assert (starts[:, 1] == ends[:, 0]).all()
    assert (ends[:, 1] == ends[:, 2]).all()


def test_ring_keeps_calls_whole_under_many_threads():
    """More threads than cores write calls at once, with the interpreter
    switching threads as often as it can: every call's spans land
    together, under its thread, in their order, and none is lost."""
    ring = T.SpanRing(1 << 16)
    codes = [ring.code(n) for n in ("a", "b", "c")]
    threads_n, calls_n = 16, 200
    done = []

    def writer():
        rec = T.CallSpans(ring, "root")
        for _ in range(calls_n):
            rec.open()
            for c in codes[:-1]:
                rec.end(c)
            rec.close(codes[-1])
        done.append(threading.get_native_id())

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert len(done) == threads_n
    assert ring.recorded == threads_n * calls_n * 4
    a = ring.arrays()
    names = [ring.names[n] for n in a["name"]]
    assert names == ["a", "b", "c", "root"] * (threads_n * calls_n)
    calls = a["call"].reshape(-1, 4)
    tids = a["tid"].reshape(-1, 4)
    assert (calls == calls[:, -1:]).all() and (tids == tids[:, -1:]).all()
    assert set(tids[:, 0].tolist()) == set(done)
    starts = a["start_ns"].reshape(-1, 4)
    ends = a["end_ns"].reshape(-1, 4)
    assert (starts[:, 1:3] == ends[:, 0:2]).all()
    assert (starts[:, 3] == starts[:, 0]).all()
    assert (ends[:, 2] == ends[:, 3]).all()


# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------

def _data(seed, n=3000):
    data = np.random.RandomState(seed).randint(0, 256, n, np.uint8).tobytes()
    return data, gear_cdc.chunk_stream_np(data, GEO["min_size"],
                                          GEO["avg_bits"], GEO["max_size"])


def _calls(since):
    """The engine's calls recorded since ``since``: {call id: spans in
    the order written (children, then the root)}."""
    a = T.SPAN_RING.arrays(since_ns=since)
    by = {}
    for i in range(len(a["seq"])):
        by.setdefault(int(a["call"][i]), []).append(
            (T.SPAN_RING.names[a["name"][i]], int(a["start_ns"][i]),
             int(a["end_ns"][i]), int(a["tid"][i]), int(a["parent_seq"][i]),
             int(a["seq"][i])))
    return by


def _check_call(spans, names):
    *children, root = spans
    assert root[0] == "engine.fingerprint" and root[4] == -1
    assert [c[0] for c in children] == names
    assert all(c[4] == root[5] and c[3] == root[3] for c in children)
    # The children follow one another and cover the root from end to end.
    assert root[1] == children[0][1] and children[-1][2] == root[2]
    for a, b in zip(children, children[1:]):
        assert a[2] == b[1]


def test_engine_call_writes_its_stages():
    """Given its cuts, and finding them itself (``engine.cuts`` then
    holds the CDC), a call writes the same stages."""
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    data, cuts = _data(1)
    for given in (cuts, None):
        since = T.time.time_ns()
        spans, _, _ = eng.fingerprint(data, given)
        np.testing.assert_array_equal([o + n for o, n in spans], cuts)
        calls = _calls(since)
        assert len(calls) == 1
        _check_call(next(iter(calls.values())), CHILDREN)


def test_engine_fan_out_writes_each_runs_stages():
    eng = DedupEngine(DedupConfig(**GEO, fan_out=2), device="cpu")
    data, cuts = _data(2)
    since = T.time.time_ns()
    eng.fingerprint(data, cuts)
    (spans,) = _calls(since).values()
    run = ["engine.table", "engine.upload", "engine.launch"]
    _check_call(spans, ["engine.cuts", "engine.stage_wait",
                        "engine.stage_copy", *run, *run,
                        "engine.copy_back", "engine.copy_back",
                        "engine.unpack"])


def test_engine_call_without_chunks_writes_its_root():
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    since = T.time.time_ns()
    spans, digests, _ = eng.fingerprint(b"", cuts=[])
    assert spans == [] and digests.shape == (0, 5)
    (call,) = _calls(since).values()
    _check_call(call, ["engine.cuts"])


def test_engine_threads_keep_their_calls_apart():
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    inputs = [_data(10 + k, 1500) for k in range(4)]
    want = [eng.fingerprint(d, c) for d, c in inputs]
    since = T.time.time_ns()
    got = [None] * 4
    tids = [None] * 4
    go = threading.Barrier(4)

    def stream(k):
        tids[k] = threading.get_native_id()
        go.wait()
        got[k] = [eng.fingerprint(*inputs[k]) for _ in range(2)]

    threads = [threading.Thread(target=stream, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    calls = _calls(since)
    assert len(calls) == 8
    by_thread = {}
    for spans in calls.values():
        _check_call(spans, CHILDREN)
        by_thread.setdefault(spans[-1][3], []).append(spans[-1])
    assert sorted(by_thread) == sorted(tids)
    for roots in by_thread.values():
        assert len(roots) == 2
        first, second = sorted(roots, key=lambda r: r[1])
        assert first[2] <= second[1]
    for k in range(4):
        for out in got[k]:
            assert out[0] == want[k][0]
            np.testing.assert_array_equal(out[1], want[k][1])
            np.testing.assert_array_equal(out[2], want[k][2])
