"""A crawler's upload session on the port's sidecar, through
``DedupSidecar.handle``, against ``portbench/neardup_reference.py``.

A small store (64 groups of 16 KiB pages of ``portbench/corpora/html.py``:
base, span-edit, scattered-edit, shuffled) is loaded as the benchmark's
``node_html_neardup`` cell loads it, and pool pages run the session (125,
``commitchunks``, NEARDUPS, ``forget`` when reported) on the CPU:

- one thread: every report equals the LSH rule applied to every indexed
  file (each stored page signed from its bytes, and the uploads kept),
  and the planted-group shortcut of the benchmark's check gives the same;
- two threads: the check's order-tolerant comparison reads 0;
- the indexes after the sessions: a ``forget`` that does nothing, or
  leaves the chunks it carried, and a ``commitchunks`` without its exact
  inserts or its LSH add read ``index_state_wrong``;
- the bulk load builds the state that 125 + ``commitchunks`` builds;
- ``_serve_conn`` over a socket pair answers as ``handle`` does, and
  ``stats`` carries the indexes' counts;
- a report with a stored page dropped, a score rounded, an upload's
  score changed, or an upload listed that was forgotten before the
  report was asked for, or that is no upload, reads wrong;
- a page uploaded and forgotten again and again keeps its report (the
  index ranks no tombstone);
- a session writes the sidecar's and the index's spans, each inside its
  parent, the matrix's rebuild only after an add.

The engine's two kernel wrappers are the plain reference here
(``portbench/tests/pb_cpu.py``); their own parity is tested elsewhere.
"""

import dataclasses
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from fastdfs_tpu_torch import trace as T
from fastdfs_tpu_torch.common import protocol as proto
from fastdfs_tpu_torch.sidecar import DedupSidecar
from portbench import check, manifest, run
from portbench import neardup_reference as nd
from portbench.tests import pb_cpu

PAGE = 16 << 10
GROUPS = 64
POOL = 16
C = proto.StorageCmd
_I64 = struct.Struct(">q")
CPU = torch.device("cpu")
CALL_CHECKS = ("spans_wrong", "digests_wrong", "reports_wrong",
               "window_refs_wrong", "index_state_wrong")


@pytest.fixture(autouse=True)
def _plain_kernels(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    pb_cpu.patch_kernels(monkeypatch)
    yield
    torch.set_num_threads(prev)


def small_cell():
    cell = manifest.cell("node_html_neardup.page64")
    c = dict(cell.config["corpus"], store_pages=4 * GROUPS, page_bytes=PAGE)
    cell.config = dict(cell.config, corpus=c, corpus_bytes=POOL * PAGE,
                       dedup_segment_bytes=64 * PAGE)
    cell.traffic = dict(cell.traffic, segment_bytes=PAGE)
    return cell


def pool_of(cell, seed=2 ** 31 + 99):
    return run.make_pool(cell, seed, CPU, lambda msg: None)


def stored_pages(cell):
    c = cell.config["corpus"]
    return cell.corpus.store_groups(c, 0, c["store_pages"] // 4)


def loaded_node(cell):
    return cell.call.make_system(cell, CPU)


def test_one_stream_reports_the_rule_over_every_indexed_file():
    cell = small_cell()
    node = loaded_node(cell)
    pool = pool_of(cell)
    d = cell.dedup
    bands, threshold = cell.config["lsh_bands"], cell.config[
        "near_dup_threshold"]
    indexed = {f"group1/S/{j}": nd.signature(p.tobytes(), d)
               for j, p in enumerate(stored_pages(cell))}
    answers = {i: cell.call.reference(item, cell)
               for i, item in enumerate(pool)}
    kinds = {"span": 0, "scattered": 0, "shuffle": 0}
    # Two passes: the second finds the first's kept uploads indexed.
    for item in pool + pool:
        ans = answers[item.index]
        got = cell.call.call(node, item)
        want = {(ref, score) for ref, sig in indexed.items()
                if (score := nd.reported(ans.sig, sig, bands,
                                         threshold)) is not None}
        listed = {(f"group1/S/{j}", s) for j, s in got.stored} | set(
            got.window)
        assert listed == want
        assert got.other == 0
        # The planted-group shortcut of the benchmark's check.
        assert {(f"group1/S/{j}", s) for j, s in ans.stored} == {
            p for p in want if p[0].startswith("group1/S/")}
        assert cell.call.compare([check.Kept(item.index, got)],
                                 answers) == dict.fromkeys(CALL_CHECKS, 0)
        assert cell.call.rows(got) == cell.call.expected_rows(item, cell)
        if not want:
            # Kept: the next report may list it.
            uploads = [r for r, u in node.uploads.items()
                       if u.index == item.index]
            indexed[uploads[-1]] = ans.sig
        kinds[item.kind] += bool(got.stored)
    # Edited pages find their stored near-duplicates, shuffles none.
    assert kinds["shuffle"] == 0
    assert kinds["span"] + kinds["scattered"] == 2 * sum(
        p.kind != "shuffle" for p in pool) > 0


def test_two_streams_hold_the_order_tolerant_rule():
    cell = small_cell()
    node = loaded_node(cell)
    pool = pool_of(cell, seed=7)
    answers = {i: cell.call.reference(item, cell)
               for i, item in enumerate(pool)}
    kept, errors = [], []

    def stream(k):
        rng = np.random.default_rng(k)
        try:
            for s in np.concatenate([rng.permutation(POOL)
                                     for _ in range(3)]).tolist():
                out = cell.call.call(node, pool[s])
                assert cell.call.rows(out) == cell.call.expected_rows(
                    pool[s], cell)
                kept.append(check.Kept(s, out))
        except Exception as e:  # noqa: BLE001  reported below
            errors.append(e)

    threads = [threading.Thread(target=stream, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(kept) == 6 * POOL
    assert cell.call.compare(kept, answers) == dict.fromkeys(CALL_CHECKS, 0)
    assert any(k.answer.window for k in kept)


def _no_op(*args):
    return 0


@pytest.mark.parametrize("fault", [None, "forget", "carrier_mask",
                                   "exact_insert", "near_add"])
def test_the_indexes_hold_forget_and_commit(fault):
    """After the sessions every forgotten upload is out of both indexes
    and every kept one in them; a sidecar that skips one update reads
    ``index_state_wrong``."""
    cell = small_cell()
    node = loaded_node(cell)
    sc = node.sidecar
    if fault == "forget":
        sc._forget = _no_op
    elif fault == "carrier_mask":
        sc.engine.exact.remove_by_carrier = _no_op
    elif fault == "exact_insert":
        sc.engine.exact.insert = _no_op
    elif fault == "near_add":
        sc.engine.near.add = _no_op
    pool = pool_of(cell)
    answers = {i: cell.call.reference(p, cell) for i, p in enumerate(pool)}
    kept = [check.Kept(p.index, cell.call.call(node, p))
            for p in pool + pool]
    got = cell.call.compare(kept, answers)
    if fault is None:
        forgotten = sum(u.forgotten is not None
                        for u in node.uploads.values())
        assert 0 < forgotten < len(node.uploads)
        assert got == dict.fromkeys(CALL_CHECKS, 0)
    else:
        assert got["index_state_wrong"] > 0, got
    if fault == "forget":
        # The second pass's reports list the first's forgotten uploads.
        assert got["window_refs_wrong"] > 0


def test_the_bulk_load_builds_what_125_and_commitchunks_build():
    cell = small_cell()
    loaded = loaded_node(cell).sidecar
    one = DedupSidecar("", None, loaded.engine.config, device=CPU)
    for j, page in enumerate(stored_pages(cell)):
        data = page.tobytes()
        cuts = nd.cuts(data, cell.dedup)
        status, _ = one.handle(C.DEDUP_FINGERPRINT_CUTS, _I64.pack(j)
                               + _I64.pack(0) + _I64.pack(len(cuts))
                               + np.asarray(cuts, ">i8").tobytes() + data)
        assert status == 0
        commit = f"commitchunks {j} group1/S/{j}".encode()
        assert one.handle(C.DEDUP_COMMIT, commit) == (0, b"")
    a, b = loaded.engine, one.engine
    assert len(a.exact) == len(b.exact) > 4 * GROUPS
    assert sorted(a.exact.items()) == sorted(b.exact.items())
    assert a.near._refs == b.near._refs
    assert np.array_equal(a.near.signatures, b.near.signatures)
    assert a.near._buckets == b.near._buckets


def _requests(pool):
    body = [_I64.pack(s) + _I64.pack(0) + p.cut_table + p.data
            for s, p in enumerate(pool[:2])]
    return [
        (C.DEDUP_FINGERPRINT_CUTS, body[0]),
        (C.DEDUP_COMMIT, b"commitchunks 0 group1/W/a"),
        (C.DEDUP_NEARDUPS, b"group1/W/a"),
        (C.DEDUP_FINGERPRINT_CUTS, body[1]),
        (C.DEDUP_COMMIT, b"commitchunks 1 group1/W/b"),
        (C.DEDUP_NEARDUPS, b"group1/W/b"),
        (C.DEDUP_COMMIT, b"forget group1/W/a"),
        (C.DEDUP_NEARDUPS, b"group1/W/a"),
        (C.DEDUP_QUERY, b"0" * 40),
        (C.ACTIVE_TEST, b""),
        (99, b""),
        (C.DEDUP_COMMIT, b"stats"),
    ]


def _without_timing(cmd, body, answer):
    status, resp = answer
    if body != b"stats":
        return answer
    stats = json.loads(resp)
    return status, {k: v for k, v in stats.items()
                    if k not in ("lock_wait_us", "engine_us")}


def test_the_socket_loop_answers_as_handle_does():
    cell = small_cell()
    pool = pool_of(cell)
    served, direct = loaded_node(cell).sidecar, loaded_node(cell).sidecar
    near_rows = len(served.engine.near)
    mine, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    mine.settimeout(60)
    loop = threading.Thread(target=served._serve_conn, args=(theirs,),
                            daemon=True)
    loop.start()
    try:
        for cmd, body in _requests(pool):
            mine.sendall(proto.pack_header(len(body), cmd) + body)
            head = b""
            while len(head) < proto.HEADER_SIZE:
                head += mine.recv(proto.HEADER_SIZE - len(head))
            h = proto.unpack_header(head)
            resp = b""
            while len(resp) < h.pkg_len:
                resp += mine.recv(h.pkg_len - len(resp))
            assert h.cmd == C.RESP
            assert _without_timing(cmd, body, (h.status, resp)) == \
                _without_timing(cmd, body, direct.handle(cmd, body))
    finally:
        mine.close()
    loop.join(timeout=30)
    assert not loop.is_alive()
    stats = json.loads(direct.handle(C.DEDUP_COMMIT, b"stats")[1])
    assert stats["requests"] == len(_requests(pool)) + 1
    assert stats["near_rows"] == near_rows + 2
    assert stats["near_dead"] == 1
    assert stats["near_stack_rebuilds"] >= 2
    assert stats["near_candidates"] >= 3
    assert stats["exact_delta"] + stats["exact_merges"] > 0
    assert set(stats) >= {"near_rows", "near_dead", "near_stack_rebuilds",
                          "near_candidates", "exact_delta", "exact_merges"}


@pytest.mark.parametrize("fault", ["drop", "round", "window", "forgotten",
                                   "unknown"])
def test_a_wrong_report_reads_wrong(fault):
    cell = small_cell()
    node = loaded_node(cell)
    pool = pool_of(cell)
    answers = {i: cell.call.reference(p, cell) for i, p in enumerate(pool)}

    def rounded(score):
        return f"{round(float(score), 2):.4f}"

    # A page whose report has a score that rounding to 2 places changes.
    item = next(p for p in pool if any(
        rounded(s) != s for _, s in answers[p.index].stored))
    got = cell.call.call(node, item)
    assert len(got.stored) >= 3

    def wrong(session):
        return cell.call.compare([check.Kept(item.index, session)], answers)

    # Another upload of the same page, committed before the report and
    # forgotten after it, listed with its score, is right.
    other = cell.call.Upload(item.index, commit=got.asked - 1,
                             committed=got.asked - 1,
                             forgotten=got.answered + 1)
    node.uploads["group1/W/other"] = other
    same = dataclasses.replace(got, window=[("group1/W/other", "1.0000")])
    assert wrong(got) == wrong(same) == dict.fromkeys(CALL_CHECKS, 0)
    field = "window_refs_wrong"
    if fault == "drop":
        bad, field = dataclasses.replace(got, stored=got.stored[1:]), \
            "reports_wrong"
    elif fault == "round":
        k = next(k for k, (_, s) in enumerate(got.stored)
                 if rounded(s) != s)
        j, s = got.stored[k]
        stored = list(got.stored)
        stored[k] = (j, rounded(s))
        bad, field = dataclasses.replace(got, stored=stored), "reports_wrong"
    elif fault == "window":
        bad = dataclasses.replace(
            got, window=[("group1/W/other", "0.9844")])
    elif fault == "forgotten":
        other.forgotten = got.asked - 0.5
        bad = same
    else:
        bad = dataclasses.replace(got, window=[("group1/W/none", "1.0000")])
    assert wrong(bad)[field] > 0


def test_a_page_uploaded_and_forgotten_again_keeps_its_report():
    cell = small_cell()
    node = loaded_node(cell)
    pool = pool_of(cell)
    item = next(p for p in pool if p.kind != "shuffle")
    want = cell.call.reference(item, cell).stored
    assert len(want) >= 3
    for _ in range(2 * cell.config["near_dup_top_k"] + 4):
        got = cell.call.call(node, item)
        assert set(got.stored) == want and got.statuses == (0, 0, 0, 0)
    assert node.sidecar.engine.near.counts()["near_dead"] >= 14


def test_a_session_writes_its_spans():
    cell = small_cell()
    node = loaded_node(cell)
    sc = node.sidecar
    page = next(p for p in pool_of(cell) if p.kind != "shuffle")
    since = time.time_ns()
    body = _I64.pack(77) + _I64.pack(0) + page.cut_table + page.data
    assert sc.handle(C.DEDUP_FINGERPRINT_CUTS, body)[0] == 0
    assert sc.handle(C.DEDUP_COMMIT, b"commitchunks 77 group1/W/x") == (0,
                                                                         b"")
    assert sc.handle(C.DEDUP_NEARDUPS, b"group1/W/x")[1]
    assert sc.handle(C.DEDUP_NEARDUPS, b"group1/W/x")[1]
    assert sc.handle(C.DEDUP_COMMIT, b"forget group1/W/x") == (0, b"")
    a = T.SPAN_RING.arrays(since)
    mine = a["tid"] == threading.get_native_id()
    a = {k: v[mine] for k, v in a.items()}
    names = [T.SPAN_RING.names[n] for n in a["name"]]
    seq = {int(s): i for i, s in enumerate(a["seq"])}
    calls = {}
    for i, parent in enumerate(a["parent_seq"].tolist()):
        if parent >= 0:
            p = seq[parent]
            assert a["start_ns"][p] <= a["start_ns"][i] <= a["end_ns"][i] \
                <= a["end_ns"][p]
            calls.setdefault(p, []).append(names[i])
    by_root = [(names[p], children) for p, children in sorted(calls.items())]
    assert [r for r, _ in by_root] == [
        "engine.fingerprint", "sidecar.fingerprint", "sidecar.commit",
        "sidecar.neardups", "sidecar.neardups", "sidecar.forget"]
    assert [c for _, c in by_root[1:]] == [
        ["sidecar.parse", "sidecar.engine", "sidecar.lock_wait",
         "sidecar.respond"],
        ["sidecar.lock_wait", "index.exact_insert", "index.near_add"],
        ["sidecar.lock_wait", "index.near_candidates", "index.near_stack",
         "index.near_score", "sidecar.respond"],
        ["sidecar.lock_wait", "index.near_candidates", "index.near_score",
         "sidecar.respond"],
        ["sidecar.lock_wait", "index.near_remove", "index.exact_remove"]]
    # The engine's call lies inside the request's sidecar.engine stage.
    engine = names.index("engine.fingerprint")
    stage = names.index("sidecar.engine")
    assert a["start_ns"][stage] <= a["start_ns"][engine] \
        <= a["end_ns"][engine] <= a["end_ns"][stage]
