"""The port's dedup sidecar (fastdfs_tpu_torch.sidecar) against the JAX
package's, both on the CPU in threads: the same request sequence over
the unix socket must give byte-equal responses (except the timing
fields of ``stats``), and a state dir written by either resumes in the
other.

Tolerance: exact equality of every response byte.
"""

import hashlib
import json
import os
import socket
import struct
import tempfile
import threading

import numpy as np
import pytest
import torch

from fastdfs_tpu import sidecar as jsidecar
from fastdfs_tpu.dedup import DedupConfig as JConfig
from fastdfs_tpu_torch import sidecar as tsidecar
from fastdfs_tpu_torch.common import protocol as tproto
from fastdfs_tpu_torch.dedup import DedupConfig
from fastdfs_tpu_torch.ops import gear_cdc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

GEO = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
_I64 = struct.Struct(">q")
_TIMING = ("lock_wait_us", "engine_us")
# The port's own counters in ``stats`` (how the engine's staging copy
# ran), which the reference does not keep.
_STAGE = ("stage_sliced", "stage_inline", "stage_pool_slices")
# And the indexes' counts (``counts()`` of each index).
_INDEX = ("near_rows", "near_dead", "near_stack_rebuilds", "near_candidates",
          "exact_delta", "exact_merges")


def _hashlib_batch_sha1(chunks):
    # The reference sidecar's own host fallback for DEDUP_VERIFY, used in
    # place of its XLA sha1_batch, which costs minutes of CPU compile per
    # new (N, L) shape; the answers are the same by contract.
    return [hashlib.sha1(c).digest() for c in chunks]


class _Served:
    """A sidecar serving on a unix socket in a thread, plus a client."""

    def __init__(self, sidecar):
        self.sidecar = sidecar
        ready = threading.Event()
        self.thread = threading.Thread(
            target=sidecar.serve_forever, kwargs={"ready_event": ready},
            daemon=True)
        self.thread.start()
        assert ready.wait(timeout=30)
        self.conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.conn.settimeout(60)
        self.conn.connect(sidecar.socket_path)

    def call(self, cmd, body=b""):
        self.conn.sendall(tproto.pack_header(len(body), cmd) + body)
        hdr = self._recv(tproto.HEADER_SIZE)
        h = tproto.unpack_header(hdr)
        assert h.cmd == tproto.StorageCmd.RESP
        return h.status, self._recv(h.pkg_len)

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            got = self.conn.recv(n - len(buf))
            assert got, "sidecar closed the connection"
            buf.extend(got)
        return bytes(buf)

    def close(self):
        self.conn.close()
        self.sidecar.stop()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _port(sock, state_dir):
    return _Served(tsidecar.DedupSidecar(sock, state_dir, DedupConfig(**GEO),
                                         device="cpu"))


def _reference(sock, state_dir, monkeypatch):
    sc = jsidecar.DedupSidecar(sock, state_dir, JConfig(**GEO))
    monkeypatch.setattr(sc, "_batch_sha1", _hashlib_batch_sha1)
    return _Served(sc)


def _corpus():
    rng = np.random.RandomState(11)
    a = rng.randint(0, 256, 12_000, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for pos in (100, 5000, 9000):
        b[pos:pos + 4] = b"edit"
    return a, bytes(b), rng.randint(0, 256, 3000, dtype=np.uint8).tobytes()


def _cuts_body(session, base, data):
    cuts = gear_cdc.chunk_stream_np(data, GEO["min_size"], GEO["avg_bits"],
                                    GEO["max_size"])
    return (_I64.pack(session) + _I64.pack(base) + _I64.pack(len(cuts))
            + b"".join(_I64.pack(c) for c in cuts) + data)


def _verify_body(chunks, expected):
    head = _I64.pack(len(chunks)) + b"".join(
        _I64.pack(len(c)) + d for c, d in zip(chunks, expected))
    return head + b"".join(chunks)


def _requests():
    """The request sequence both sidecars answer, as (name, cmd, body):
    every opcode, the commit/abort/forget lifecycle and malformed bodies."""
    C = tproto.StorageCmd
    a, b, d = _corpus()
    sha_a = hashlib.sha1(a).hexdigest()
    chunks = [a[:100], a[100:1000], b"", a[1000:3000]]
    expected = [hashlib.sha1(c).digest() for c in chunks]
    expected[1] = hashlib.sha1(b"other").digest()   # one corrupted chunk
    return [
        ("active_test", C.ACTIVE_TEST, b""),
        ("fingerprint_cuts_a", C.DEDUP_FINGERPRINT_CUTS, _cuts_body(1, 0, a)),
        ("commitchunks_a", C.DEDUP_COMMIT, b"commitchunks 1 group1/fa"),
        ("commitfile_a", C.DEDUP_COMMIT,
         f"commitfile {sha_a} group1/fa".encode()),
        ("query_known", C.DEDUP_QUERY, sha_a.encode()),
        ("query_unknown", C.DEDUP_QUERY, b"0" * 40),
        ("fingerprint_b", C.DEDUP_FINGERPRINT,
         _I64.pack(2) + _I64.pack(4096) + b),
        ("commitchunks_b", C.DEDUP_COMMIT, b"commitchunks 2 group1/fb"),
        ("neardups_b", C.DEDUP_NEARDUPS, b"group1/fb"),
        ("neardups_unknown", C.DEDUP_NEARDUPS, b"group1/nope"),
        ("fingerprint_d", C.DEDUP_FINGERPRINT, _I64.pack(3) + _I64.pack(0) + d),
        ("abort_d", C.DEDUP_COMMIT, b"abort 3"),
        ("fingerprint_cuts_c", C.DEDUP_FINGERPRINT_CUTS, _cuts_body(4, 0, a)),
        ("commitchunks_c", C.DEDUP_COMMIT, b"commitchunks 4 group1/fc"),
        ("forget_c", C.DEDUP_COMMIT, b"forget group1/fc"),
        ("neardups_forgotten", C.DEDUP_NEARDUPS, b"group1/fc"),
        ("verify", C.DEDUP_VERIFY, _verify_body(chunks, expected)),
        ("verify_empty", C.DEDUP_VERIFY, _I64.pack(0)),
        ("bad_cuts", C.DEDUP_FINGERPRINT_CUTS,
         _I64.pack(5) + _I64.pack(0) + _I64.pack(1) + _I64.pack(7) + a[:10]),
        ("short_fingerprint", C.DEDUP_FINGERPRINT, b"short"),
        ("short_verify", C.DEDUP_VERIFY, b"\x00"),
        ("empty_commit", C.DEDUP_COMMIT, b""),
        ("bogus_commit", C.DEDUP_COMMIT, b"bogus x y"),
        ("unknown_cmd", 99, b""),
        ("stats", C.DEDUP_COMMIT, b"stats"),
    ]


_NAMES = [name for name, _, _ in _requests()]


def _answer(served, name, cmd, body):
    status, resp = served.call(cmd, body)
    if name == "stats":
        stats = json.loads(resp)
        return status, {k: v for k, v in stats.items() if k not in _TIMING}
    return status, resp


def _run(served):
    try:
        return {name: _answer(served, name, cmd, body)
                for name, cmd, body in _requests()}
    finally:
        served.close()


@pytest.fixture(scope="module")
def runs():
    """Both sidecars answer the whole sequence once, each with its own
    state dir (snapshotted when it stops)."""
    # Short path: unix socket names are limited to ~108 bytes.
    with tempfile.TemporaryDirectory(prefix="fdfs") as d, \
            pytest.MonkeyPatch.context() as mp:
        state = {"port": os.path.join(d, "st_t"), "ref": os.path.join(d, "st_j")}
        for path in state.values():
            os.mkdir(path)
        got = _run(_port(os.path.join(d, "t.sock"), state["port"]))
        want = _run(_reference(os.path.join(d, "j.sock"), state["ref"], mp))
        yield got, want, d, state, mp


def test_opcode_constants_match_reference():
    from fastdfs_tpu.common import protocol as jproto

    assert tproto.HEADER_SIZE == jproto.HEADER_SIZE
    for name in ("RESP", "ACTIVE_TEST", "DEDUP_FINGERPRINT", "DEDUP_QUERY",
                 "DEDUP_COMMIT", "DEDUP_NEARDUPS", "DEDUP_FINGERPRINT_CUTS",
                 "DEDUP_VERIFY"):
        assert tproto.StorageCmd[name] == jproto.StorageCmd[name]
    h = jproto.pack_header(123, 125, 7)
    assert tproto.pack_header(123, 125, 7) == h
    assert tproto.unpack_header(h) == tproto.Header(123, 125, 7)
    assert tproto.Header(5, 100).pack() == jproto.Header(5, 100).pack()


def _shared(name, answer):
    """An answer without the port's own counters."""
    if name != "stats":
        return answer
    status, stats = answer
    return status, {k: v for k, v in stats.items()
                    if k not in _STAGE + _INDEX}


@pytest.mark.parametrize("name", _NAMES)
def test_response_matches_reference(runs, name):
    got, want, _, _, _ = runs
    assert _shared(name, got[name]) == want[name]


def test_stats_carry_the_staging_copy_counters(runs):
    """Every body of the sequence is small: each fingerprint request is
    copied inline, none in slices (this sidecar runs no warm-up)."""
    got, want, _, _, _ = runs
    status, stats = got["stats"]
    fingerprints = sum(1 for name, _, _ in _requests()
                       if name.startswith("fingerprint_"))
    assert status == 0 and not set(_STAGE) & set(want["stats"][1])
    assert {k: stats[k] for k in _STAGE} == {
        "stage_sliced": 0, "stage_inline": fingerprints,
        "stage_pool_slices": 0}


def test_responses_carry_the_expected_verdicts(runs):
    got = runs[0]
    assert got["fingerprint_cuts_a"][0] == 0
    assert got["fingerprint_cuts_c"] == got["fingerprint_cuts_a"]
    assert got["verify"] == (0, b"\x00\x01\x00\x00")
    assert b"group1/fa" in got["neardups_b"][1]
    assert got["neardups_forgotten"][0] == 61
    assert got["bad_cuts"][0] == 22


def test_state_dirs_resume_across_packages(runs):
    """Each sidecar resumes the state dir the other wrote and answers the
    same queries the same way."""
    _, want, d, state, mp = runs
    a, _, _ = _corpus()
    C = tproto.StorageCmd
    queries = [(C.DEDUP_NEARDUPS, b"group1/fb"),
               (C.DEDUP_NEARDUPS, b"group1/fa"),
               (C.DEDUP_QUERY, hashlib.sha1(a).hexdigest().encode()),
               (C.DEDUP_FINGERPRINT_CUTS, _cuts_body(9, 0, a))]
    resumed = []
    for served in (_port(os.path.join(d, "t2.sock"), state["ref"]),
                   _reference(os.path.join(d, "j2.sock"), state["port"], mp)):
        try:
            answers = [served.call(cmd, body) for cmd, body in queries]
            resumed.append((answers, list(served.sidecar.engine.exact.items())))
        finally:
            served.close()
    (t_answers, t_items), (j_answers, j_items) = resumed
    assert t_answers == j_answers
    assert t_answers[0] == want["neardups_b"]
    assert t_answers[2] == want["query_known"]
    assert t_answers[3] == want["fingerprint_cuts_a"]
    assert t_items and t_items == j_items


def test_trace_returns_the_engines_spans():
    """``trace`` on DEDUP_COMMIT answers the newest spans of the
    process's ring as a TRACE_DUMP object: the fingerprint calls' stages,
    which the trace tools decode and render."""
    from fastdfs_tpu_torch import trace as T

    a, _, _ = _corpus()
    C = tproto.StorageCmd
    with tempfile.TemporaryDirectory(prefix="fdfs") as d:
        served = _port(os.path.join(d, "t.sock"), None)
        try:
            since_us = T.time.time_ns() // 1000
            status, _ = served.call(C.DEDUP_FINGERPRINT_CUTS,
                                    _cuts_body(1, 0, a))
            assert status == 0
            status, resp = served.call(C.DEDUP_COMMIT, b"trace")
        finally:
            served.close()
    assert status == 0
    dump = json.loads(resp)
    assert dump["role"] == "sidecar"
    assert dump["recorded"] >= len(dump["spans"]) > 0
    assert dump["dropped"] == max(0, dump["recorded"] - T.RING_CAPACITY)
    assert len(dump["spans"]) <= tsidecar.TRACE_SPANS
    spans = [s for s in T.decode_dump(dump) if s.start_us >= since_us]
    roots = [s for s in spans if s.name == "engine.fingerprint"]
    assert len(roots) == 1
    call = T.stitch(spans)[roots[0].trace_id]
    assert [s.name for s in call] == [
        "engine.fingerprint", "engine.cuts", "engine.stage_wait",
        "engine.stage_copy",
        "engine.table", "engine.upload", "engine.launch",
        "engine.copy_back", "engine.unpack"]
    assert "engine.copy_back" in T.render_timeline(spans, roots[0].trace_id)
