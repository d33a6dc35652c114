"""A configuration, a traffic mix and a metric added as files, with their
entries in BENCHMARK.json, are found by name: nothing else is edited."""

import json
import shutil

import pytest

from portbench import manifest


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
    # The cells already there keep their metrics.
    old = manifest.cell("node_text_cdc.seg64", root=checkout)
    assert "engine.calls" not in [m.name for m in old.per_layer]
    assert len(old.per_layer) == 6


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
    cell = manifest.cell(name)
    assert {m.name for m in cell.end_to_end} == {"ingest_GBps", "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        "engine.call_p50_ms", "engine.call_p95_ms", "engine.h2d_GBps",
        "kernel.sha1_roofline", "kernel.sketch_roofline", "device.idle_pct"}


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
