"""The ``node_html_neardup.page64`` cell on the CPU: a run through
``run.run_cell`` at a small store reads ``correct`` with its eight check
lines, and not correct where the sidecar's ``forget`` does nothing or
leaves its chunks, or its ``commitchunks`` skips the exact inserts; its
five per-layer readers read the sidecar's and the index's spans of real
sessions, and its files are found by name; the ``html`` corpus makes any
stored page on its own, the same on the card as on the CPU, its classes
at the configuration's odds; the bulk load's cuts are
``cdc.select_cuts``' page by page, and the reference's NumPy gear hash
finds the benchmark's cuts."""

import json
import time

import numpy as np
import pytest
import torch

import pb_cpu
from portbench import cdc, corpus, manifest, run, spans
from portbench import neardup_reference as nd
from portbench.trace import Trace

NAME = "node_html_neardup.page64"
READERS = ["sidecar.fingerprint_ms", "sidecar.commit_ms",
           "sidecar.neardups_ms", "sidecar.forget_ms",
           "index.near_stack_ms"]
# The accepted metrics that read this cell too: the engine's spans and
# uploads, the kernels' rooflines and the card's idle share.
SHARED = ["engine.h2d_GBps", "kernel.sha1_roofline",
          "kernel.sketch_roofline", "device.idle_pct",
          "engine.stage_copy_ms", "engine.copy_back_ms", "engine.unpack_ms"]
CHECKS = ["calls_failed", "session_rows_wrong", "segments_unchecked",
          "spans_wrong", "digests_wrong", "reports_wrong",
          "window_refs_wrong", "index_state_wrong"]
PAGE = 16 << 10


def small_cell(groups=64, pool=16):
    cell = manifest.cell(NAME)
    c = dict(cell.config["corpus"], store_pages=4 * groups, page_bytes=PAGE)
    cell.config = dict(cell.config, corpus=c, corpus_bytes=pool * PAGE,
                       dedup_segment_bytes=64 * PAGE)
    cell.traffic = dict(cell.traffic, segment_bytes=PAGE)
    return cell


def test_the_cell_is_found_from_files_and_entries():
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cell = manifest.cell(NAME)
    assert cell.call.__file__ == str(manifest.HERE / "calls"
                                     / "neardup_session.py")
    assert cell.corpus.__file__ == str(manifest.HERE / "corpora" / "html.py")
    assert cell.streams == 2 and cell.chips == 1
    assert [m.name for m in cell.end_to_end] == ["ingest_GBps", "setup_s"]
    assert [m.name for m in cell.per_layer] == SHARED + READERS
    assert {m.entry["layer"] for m in cell.per_layer[len(SHARED):]} == {
        "sidecar", "index"}
    # The cells already there report none of the new metrics.
    for w in bench["workloads"]:
        if w["name"] != NAME:
            assert not {m.name for m in manifest.cell(w["name"]).per_layer} \
                & set(READERS)


def test_a_small_store_runs_correct(monkeypatch):
    pb_cpu.patch_kernels(monkeypatch)
    res = pb_cpu.run_cpu(small_cell(), 2 ** 31 + 2025, seconds=2.0)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == CHECKS
    assert res["failed"] == 0 and res["attempted"] >= 16
    assert set(res["metrics"]) == {"ingest_GBps", "setup_s"}


def test_a_dropped_stored_ref_is_not_correct(monkeypatch):
    pb_cpu.patch_kernels(monkeypatch)
    cell = small_cell()
    real = cell.call.call

    def dropping(system, item):
        out = real(system, item)
        out.stored = out.stored[1:]
        return out

    monkeypatch.setattr(cell.call, "call", dropping)
    res = pb_cpu.run_cpu(cell, 2 ** 31 + 2026, seconds=1.0)
    assert not res["correct"]
    assert res["checks"]["reports_wrong"]["value"] > 0


def _no_op(*args):
    return 0


@pytest.mark.parametrize("fault", ["forget", "carrier_mask",
                                   "exact_insert"])
def test_a_sidecar_that_skips_an_index_update_is_not_correct(monkeypatch,
                                                              fault):
    """A loaded node whose ``forget`` does nothing, whose ``forget``
    leaves the chunks it carried, or whose ``commitchunks`` makes no
    exact inserts, run as the system under test."""
    pb_cpu.patch_kernels(monkeypatch)
    cell = small_cell()
    node = cell.call.make_system(cell, torch.device("cpu"))
    if fault == "forget":
        node.sidecar._forget = _no_op
    elif fault == "carrier_mask":
        node.sidecar.engine.exact.remove_by_carrier = _no_op
    else:
        node.sidecar.engine.exact.insert = _no_op
    res = pb_cpu.run_cpu(cell, 2 ** 31 + 2027, seconds=1.0, system=node)
    assert not res["correct"]
    assert res["checks"]["index_state_wrong"]["value"] > 0, res["checks"]


def test_the_readers_read_the_spans_of_sessions(monkeypatch):
    """Real sessions on the CPU, laid under a hand-made trace of their
    time with one device operation (a run without a card has none)."""
    pb_cpu.patch_kernels(monkeypatch)
    cell = small_cell()
    node = cell.call.make_system(cell, torch.device("cpu"))
    pool = run.make_pool(cell, 5, "cpu", lambda msg: None)
    w0 = time.time_ns()
    for item in pool + pool:
        cell.call.call(node, item)
    w1 = time.time_ns()

    class HandRun:
        trace = Trace([("kernel", w0, w0 + 1000)], [], (w0, w1))

    for m in cell.per_layer[len(SHARED):]:
        v = m.reader.read(HandRun())
        assert v is not None and v > 0, m.name
        assert m.reader.read(type("R", (), {"trace": None})()) is None
    # The matrix is built again after each add, never more than once a
    # report: as many rebuilds as reports in the window.
    got = spans.window_spans(HandRun())
    assert len(got.durations_ms("index.near_stack")) == \
        len(got.durations_ms("sidecar.neardups")) == 2 * len(pool)


def test_a_parent_without_the_method_fails_at_once(monkeypatch):
    from fastdfs_tpu_torch.sidecar import DedupSidecar

    monkeypatch.delattr(DedupSidecar, "commit_chunks")
    with pytest.raises(AttributeError, match="commit_chunks"):
        small_cell().call.make_system(small_cell(), torch.device("cpu"))


def test_any_stored_page_is_made_on_its_own():
    cell = small_cell()
    c = cell.config["corpus"]
    html = cell.corpus
    many = html.store_groups(c, 3, 9)
    assert many.shape == (24, PAGE)
    for g in (3, 5, 8):
        assert (html.store_groups(c, g, g + 1)
                == many[4 * (g - 3):4 * (g - 2)]).all()

    def words(page):
        page = page.tobytes()
        assert page.startswith(html.HEAD) and html.TAIL in page
        return page[len(html.HEAD):page.index(html.TAIL)].split()

    made = {k: 0 for k in html.CLASSES}
    for j, page in enumerate(many):
        base = many[j - j % 4]
        if j % 4 == 0:
            continue
        kind = html.CLASSES[int(html.stored_class(torch.tensor(4 * 3 + j)))]
        made[kind] += 1
        if kind == "span":
            assert 0 < (base != page).sum() <= 16 * (PAGE // 3200)
        elif kind == "scattered":
            assert 0 < (base != page).sum() <= PAGE // 200
        else:
            assert words(base) != words(page)
            assert sorted(words(base)) == sorted(words(page))
    # Slots 9 to 26 of the cycle; every five slots hold 2, 2 and 1.
    assert [made[k] for k in html.CLASSES] == [7, 7, 4]
    j = torch.arange(4, 4 + 4 * 1000)
    kinds = html.stored_class(j[j % 4 != 0])
    assert torch.bincount(kinds).tolist() == [1200, 1200, 600]


@pytest.mark.gpu
def test_the_card_makes_the_stores_pages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.cell(NAME).config["corpus"]
    html = manifest.cell(NAME).corpus
    assert (html.store_groups(c, 1000, 1256, torch.device("cuda"))
            == html.store_groups(c, 1000, 1256)).all()


@pytest.mark.parametrize("trial", range(12))
def test_the_bulk_loads_cuts_are_each_pages(trial):
    rng = np.random.default_rng(trial)
    size = int(rng.choice([4096, 16384, 65536, 100_000]))
    pages = int(rng.integers(1, 40))
    n = pages * size
    cand = np.sort(rng.choice(n, size=int(n * rng.choice(
        [0.0, 1e-5, 1e-4, 1e-3, 5e-3])), replace=False)).astype(np.int64)
    lo, hi = int(rng.choice([32, 2048, 3000])), int(rng.choice([8192, 65536]))
    want, counts = [], []
    for p in range(pages):
        mine = cand[(cand >= p * size) & (cand < (p + 1) * size)] - p * size
        cuts = cdc.select_cuts(mine, size, lo, hi)
        want += [x + p * size for x in cuts]
        counts.append(len(cuts))
    got, got_counts = manifest.cell(NAME).call.page_cuts(cand, pages, size,
                                                         lo, hi)
    assert got.tolist() == want and got_counts.tolist() == counts


def test_the_plan_is_the_seeds_and_the_bytes_are_not():
    cell = small_cell()
    c = cell.config["corpus"]
    a = corpus.Corpus(c, PAGE, 16, 1, cell.corpus)
    b = corpus.Corpus(c, PAGE, 16, 2, cell.corpus)
    assert a.plans == b.plans
    assert len({base for _, base in a.plans}) == 16
    # The classes by quota: 16 x (0.4, 0.4, 0.2) = 6.4, 6.4, 3.2.
    assert [sum(k == kind for k, _ in a.plans)
            for kind in cell.corpus.CLASSES] == [7, 6, 3]
    full = corpus.Corpus(c, PAGE, 64, 1, cell.corpus)
    assert [sum(k == kind for k, _ in full.plans)
            for kind in cell.corpus.CLASSES] == [26, 25, 13]
    assert a.segment(0) == corpus.Corpus(c, PAGE, 16, 1,
                                         cell.corpus).segment(0)
    assert a.segment(0) != b.segment(0)
    assert all(len(a.segment(i)) == PAGE for i in range(16))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_references_gear_hash_finds_the_benchmarks_cuts(seed):
    data = np.random.default_rng(seed).integers(0, 256, 300_000,
                                                dtype=np.uint8).tobytes()
    d = manifest.cell(NAME).dedup
    assert nd.gear_candidates(data, d["avg_bits"]).tolist() == \
        cdc.gear_candidates(data, d["avg_bits"], "cpu").tolist()
    assert nd.cuts(data, d) == cdc.chunk_cuts(data, d["min_size"],
                                              d["avg_bits"], d["max_size"])
