"""A configuration, its call and its corpus, a traffic mix and a metric
added as files, with their entries in BENCHMARK.json, are found by name:
nothing else is edited."""

import hashlib
import json
import shutil

import numpy as np
import pytest

import pb_cpu
from portbench import corpus, manifest


@pytest.fixture
def checkout(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def add(root, config=None, traffic=None, metric=None, reader=None):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config:
        (root / "portbench" / "configs" / f"{config['name']}.json").write_text(
            json.dumps(config))
        bench["configs"].append({
            "name": config["name"], "source": "https://example.org/c",
            "file": f"portbench/configs/{config['name']}.json",
            "reduced": [], "why": "a later deployment"})
    if traffic:
        (root / "portbench" / "traffic" / f"{traffic['name']}.json").write_text(
            json.dumps(traffic))
    if metric:
        (root / "portbench" / "metrics" / f"{metric['name']}.py").write_text(
            reader)
        bench["per_layer"].append(metric)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def add_cell(root, config, traffic="seg64", files=None):
    """A configuration and its cell ``<config>.<traffic>``, with ``files``
    (path under ``portbench/``: text) written beside them."""
    for path, text in (files or {}).items():
        (root / "portbench" / path).write_text(text)
    bench = add(root, config)
    name = f"{config['name']}.{traffic}"
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": traffic, "chips": 1,
                               "why": "a later cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def per_layer_listed(name, bench):
    """The per-layer metrics ``BENCHMARK.json`` lists for cell ``name``:
    those whose ``workloads`` name it, and those without ``workloads``
    that move an end-to-end metric it reports."""
    reported = {m["name"] for m in bench["end_to_end"]
                if name in m.get("workloads", [name])}
    return {m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)}


def test_new_files_are_found_by_name(checkout):
    config = dict(manifest.cell("node_text_cdc.seg64").config,
                  name="node_text_small", corpus_bytes=1 << 28)
    traffic = {"name": "seg16", "loop": "closed", "segment_bytes": 1 << 24}
    metric = {"name": "engine.calls", "unit": "calls", "better": "higher",
              "source": "host_clock", "layer": "engine",
              "moves": "ingest_GBps",
              "workloads": ["node_text_small.seg16"]}
    reader = ('UNIT = "calls"\nLAYER = "engine"\nMOVES = "ingest_GBps"\n\n'
              'def read(run):\n    return len(run.segment)\n')
    before = {w: {m.name for m in manifest.cell(w, root=checkout).per_layer}
              for w in ("node_text_cdc.seg64", "group_bin_sha1.seg64")}
    bench = add(checkout, config, traffic, metric, reader)
    bench["workloads"].append({"name": "node_text_small.seg16",
                               "config": "node_text_small",
                               "traffic": "seg16", "chips": 1,
                               "why": "a later cell"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell("node_text_small.seg16", root=checkout)
    assert cell.config["corpus_bytes"] == 1 << 28
    assert cell.traffic["segment_bytes"] == 1 << 24
    assert cell.streams == 2
    assert [m.name for m in cell.per_layer] == ["engine.calls"]
    assert [m.name for m in cell.end_to_end] == ["ingest_GBps", "setup_s"]
    assert cell.per_layer[0].reader.read(
        type("R", (), {"segment": [1, 2, 3]})) == 3
    # The cells already there keep their metrics, as before the addition.
    for w, names in before.items():
        old = manifest.cell(w, root=checkout)
        assert {m.name for m in old.per_layer} == names
        assert "engine.calls" not in names


def test_a_reader_that_disagrees_is_refused(checkout):
    metric = {"name": "engine.bad", "unit": "ms", "better": "lower",
              "source": "host_clock", "layer": "engine",
              "moves": "ingest_GBps",
              "workloads": ["node_text_cdc.seg64"]}
    add(checkout, metric=metric, reader='UNIT = "s"\nLAYER = "engine"\n'
        'MOVES = "ingest_GBps"\n\ndef read(run):\n    return 1.0\n')
    with pytest.raises(manifest.ManifestError, match="UNIT"):
        manifest.cell("node_text_cdc.seg64", root=checkout)


@pytest.mark.parametrize("name", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_every_metric_of_the_manifest_has_its_reader(name):
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cell = manifest.cell(name)
    assert {m.name for m in cell.end_to_end} == {
        m["name"] for m in bench["end_to_end"]
        if name in m.get("workloads", [name])}
    assert {m.name for m in cell.per_layer} == per_layer_listed(name, bench)
    assert {"ingest_GBps", "setup_s"} <= {m.name for m in cell.end_to_end}
    assert len(cell.per_layer) >= 1
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read), m.name


def test_the_deployment_sets_the_streams():
    """Storages x store paths x dio threads, as the daemons call the
    sidecar."""
    assert manifest.cell("node_text_cdc.seg64").streams == 2
    assert manifest.cell("group_bin_sha1.seg64").streams == 4


@pytest.mark.parametrize("change,match", [
    ({"streams": 8}, "streams"),
    ({"loop": "open"}, "closed loop"),
])
def test_a_traffic_the_harness_cannot_run_is_refused(checkout, change, match):
    """A mix that sets its own concurrency, or asks for a loop the
    streams do not run, is refused rather than run as something else."""
    traffic = {"name": "seg64", "loop": "closed", "segment_bytes": 1 << 26,
               **change}
    add(checkout, traffic=traffic)
    with pytest.raises(manifest.ManifestError, match=match):
        manifest.cell("node_text_cdc.seg64", root=checkout)


# A later deployment's call: the 124 request's route,
# ``DedupEngine.fingerprint(data)``, where the engine cuts the segment
# itself (``gear_cdc.chunk_stream``); its reference cuts with the frozen
# rule and answers as for the 125 request.
DATA_CALL = '''"""DedupEngine.fingerprint(data): the engine's own cuts."""

from dataclasses import dataclass

import numpy as np

from portbench import cdc, check
from portbench import reference as plain

ROWS_WRONG = "chunk_counts_wrong"
LIMITS = {"chunk_counts_wrong": 0, "spans_wrong": 0, "digests_wrong": 0,
          "sigs_wrong": 0}


@dataclass
class Item:
    data: bytes
    chunks: int


def _cuts(data, cell):
    d = cell.dedup
    return cdc.chunk_cuts(data, d["min_size"], d["avg_bits"], d["max_size"])


def make_system(cell, device):
    from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine

    d = cell.dedup
    return DedupEngine(DedupConfig(
        min_size=d["min_size"], avg_bits=d["avg_bits"],
        max_size=d["max_size"], num_perms=d["num_perms"],
        shingle=d["shingle"]), device=device)


def prepare(cell, datas, device):
    return [Item(b, len(_cuts(b, cell))) for b in datas]


def call(system, item):
    return system.fingerprint(item.data)


def rows(answer):
    spans, digests, sigs = answer
    return len(spans), len(digests), len(sigs)


def expected_rows(item, cell):
    return (item.chunks,) * 3


def reference(item, cell):
    d = cell.dedup
    return plain.answer(item.data, _cuts(item.data, cell), d["shingle"],
                        d["num_perms"])


def compare(kept, answers):
    out = dict.fromkeys(("spans_wrong", "digests_wrong", "sigs_wrong"), 0)
    for k in kept:
        spans, digests, sigs = k.answer
        ans = answers[k.segment]
        out["spans_wrong"] += check.rows_wrong(
            np.asarray(spans, np.int64).reshape(-1, 2),
            np.stack([ans.offsets, ans.lens], axis=1))
        out["digests_wrong"] += check.rows_wrong(
            np.asarray(digests, np.uint32), ans.digests)
        out["sigs_wrong"] += check.rows_wrong(np.asarray(sigs, np.uint32),
                                              ans.sigs)
    return out
'''

# A later deployment's corpus: items of planned lengths between half and
# all of ``segment_bytes``, each opening with one of a few shared headers.
RECORDS = '''"""Records of planned lengths, each after a shared header."""


def setup(made, plan, shared):
    c = made.c
    made.headers = [shared.bytes(c["header_bytes"])
                    for _ in range(c["headers"])]
    made.lens = plan.integers(made.segment_bytes // 2,
                              made.segment_bytes + 1, made.segments)


def segment(made, i, rng):
    head = made.headers[int(rng.integers(len(made.headers)))]
    return head + rng.bytes(int(made.lens[i]) - len(head))
'''

ITEM = 1 << 18


def records_config(call="fingerprint_data", kind="records"):
    return dict(manifest.cell("node_text_cdc.seg64").config,
                name="node_records_data", call=call,
                corpus_bytes=3 * ITEM,
                corpus={"kind": kind, "plan_seed": 5, "headers": 4,
                        "header_bytes": 4096})


def test_a_deployment_with_its_own_call_and_corpus_is_files_only(
        checkout, monkeypatch):
    """A configuration whose call and corpus are files of its own runs
    through ``run.run_cell``, correct when sound and not when one digest
    word of its answers is flipped; no file that was there changes but
    ``BENCHMARK.json``."""
    before = hashes(checkout)
    name = add_cell(checkout, records_config(), traffic="rec256", files={
        "calls/fingerprint_data.py": DATA_CALL,
        "corpora/records.py": RECORDS,
        "traffic/rec256.json": json.dumps(
            {"loop": "closed", "segment_bytes": ITEM})})
    cell = manifest.cell(name, root=checkout)
    made = corpus.Corpus(cell.config["corpus"], ITEM, 3, 5, cell.corpus)
    lens = [len(made.segment(i)) for i in range(3)]
    assert all(ITEM // 2 <= n <= ITEM for n in lens) and min(lens) < ITEM
    pb_cpu.patch_kernels(monkeypatch)
    res = pb_cpu.run_cpu(cell, 2 ** 31 + 77)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert list(res["checks"]) == ["calls_failed", "chunk_counts_wrong",
                                   "segments_unchecked", "spans_wrong",
                                   "digests_wrong", "sigs_wrong"]
    assert set(res["metrics"]) == {"ingest_GBps", "setup_s"}

    real = cell.call.call

    def flipped(system, item):
        spans, digests, sigs = real(system, item)
        digests = np.array(digests, copy=True)
        digests[len(digests) // 2, 0] ^= 1
        return spans, digests, sigs

    monkeypatch.setattr(cell.call, "call", flipped)
    res = pb_cpu.run_cpu(cell, 2 ** 31 + 78)
    assert not res["correct"]
    assert res["checks"]["digests_wrong"]["value"] > 0

    after = hashes(checkout)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == {"BENCHMARK.json"}


@pytest.mark.parametrize("what", ["call", "corpus", "compare"])
def test_a_missing_call_or_corpus_names_its_path(checkout, what):
    files = {}
    if what == "call":
        config, path = records_config(call="no_such_call"), \
            "calls/no_such_call.py"
    elif what == "corpus":
        config, path = records_config(kind="no_such_kind"), \
            "corpora/no_such_kind.py"
        files["calls/fingerprint_data.py"] = DATA_CALL
    else:
        config, path = records_config(call="broken"), "calls/broken.py"
        files[path] = DATA_CALL.split("\ndef compare")[0]
    files["corpora/records.py"] = RECORDS
    name = add_cell(checkout, config, files=files)
    with pytest.raises(manifest.ManifestError) as e:
        manifest.cell(name, root=checkout)
    assert str(checkout / "portbench" / path) in str(e.value)
    if what == "compare":
        assert "compare" in str(e.value)


@pytest.mark.parametrize("name,kind", [("node_text_cdc.seg64", "text"),
                                       ("group_bin_sha1.seg64", "binaries")])
def test_the_cells_name_their_call_and_corpus(name, kind):
    """The two cells' configurations name no call, so they take
    ``fingerprint_cuts``; their corpus kinds are files of their own."""
    cell = manifest.cell(name)
    assert "call" not in cell.config
    assert cell.call.__file__ == str(manifest.HERE / "calls"
                                     / "fingerprint_cuts.py")
    assert cell.corpus.__file__ == str(manifest.HERE / "corpora"
                                       / f"{kind}.py")
