"""The port's configs 2 and 3 (``fastdfs_tpu_torch.bench_configs``)
against the reference's root ``bench_configs.py``: the same corpora byte
for byte and the same cuts of config 2's first document, then both
configs from the port's command line on the CPU at their smallest
scale (one document, one file), through ``tests/torch_native.py``'s
daemons and ``python -m fastdfs_tpu_torch.sidecar --platform cpu``.

The artifacts keep the checked-in reference artifacts' keys
(``bench_artifacts/config{2,3}.json``), plus the card line and the keys
that root ``bench_configs.py`` writes today and those artifacts predate.
"""

import inspect
import json
import os

import pytest

import bench_configs as ref_bc
from fastdfs_tpu_torch import bench_configs as bc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One document of config 2 (the first is 4,195,292 bytes) and one file
# of config 3 (the first is 2,359,296 bytes).
SCALE2 = 0.0003
SCALE3 = 0.00004
# Keys that the reference's code writes into each leg and the checked-in
# artifacts lack, by the reference function that writes them.
ADDED = {
    2: {"cpu_mode": {"upload_retries", "phase_wall_s", "daemon_stats"}},
    3: {"cpu_mode": {"phase_wall_s", "daemon_stats"}},
}
WRITERS = {2: ref_bc._daemon_ingest, 3: ref_bc._config3_run}


@pytest.mark.parametrize("kind,total,seed", [
    ("text", 1, 2), ("text", 5 << 20, 2), ("text", 9 << 20, 7),
    ("text", 3 << 20, 0), ("binaries", 1, 3), ("binaries", 5 << 20, 3),
    ("binaries", 9 << 20, 11), ("binaries", 3 << 20, 0),
])
def test_corpora_are_the_references(kind, total, seed):
    name = {"text": "_text_corpus", "binaries": "_mixed_binaries"}[kind]
    got = getattr(bc, name)(total, seed=seed)
    want = getattr(ref_bc, name)(total, seed=seed)
    assert len(got) == len(want) >= 1
    assert got == want


@pytest.mark.parametrize("config", [2, 3])
def test_added_keys_are_the_references(config):
    """Every key the port adds to a leg, beside the checked-in
    artifact's, is one the reference's code writes today."""
    src = inspect.getsource(WRITERS[config])
    for key in ADDED[config]["cpu_mode"]:
        assert f'"{key}"' in src, key
    assert '"sidecar_restarts"' in inspect.getsource(ref_bc._with_sidecar)


def _run(config: int, scale: float, out_dir) -> dict:
    bc.main(["--config", str(config), "--scale", str(scale), "--device",
             "cpu", "--out", str(out_dir)])
    with open(os.path.join(str(out_dir), f"config{config}.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def config2(tmp_path_factory):
    return _run(2, SCALE2, tmp_path_factory.mktemp("port2"))


@pytest.fixture(scope="module")
def config3(tmp_path_factory):
    # The suite's other workers load this host, and under load a
    # storage's admission ladder sheds a peer's replication, which the
    # daemon's sync sender never retries (native/storage/sync.cc; the
    # cluster tests run without the ladder for the same reason). The
    # benchmark itself keeps the reference's settings.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "HB", bc.HB + "\nadmission_control = 0")
        return _run(3, SCALE3, tmp_path_factory.mktemp("port3"))


def _reference_artifact(config: int) -> dict:
    with open(os.path.join(REPO, "bench_artifacts",
                           f"config{config}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("config", [2, 3])
def test_artifact_keys_are_the_references(config, request):
    art = request.getfixturevalue(f"config{config}")
    ref = _reference_artifact(config)
    assert set(art) == set(ref) | {"card"}
    added = ADDED[config]["cpu_mode"]
    assert set(art["cpu_mode"]) == set(ref["cpu_mode"]) | added
    assert set(art["sidecar_mode"]) == (set(ref["sidecar_mode"]) | added
                                        | {"sidecar_restarts"})


@pytest.mark.parametrize("config", [2, 3])
def test_sidecar_leg_counts_on_the_cpu(config, request):
    art = request.getfixturevalue(f"config{config}")
    sc = art["sidecar_mode"]
    assert bc.leg_faults(sc, art["scaled_bytes"]) == []
    assert "error" not in sc
    assert sc["sidecar_platform"] == "cpu"
    assert sc["sidecar_restarts"] == 0
    assert sc.get("upload_retries", 0) == 0
    stats = sc["sidecar_stats"]
    assert stats["fingerprint_bytes"] == art["scaled_bytes"] > 0
    assert stats["watchdog_reexecs"] == 0
    assert stats["chunks"] > 0
    assert 0.0 <= stats["lock_wait_fraction"] <= 1.0
    assert art["card"] is None


def test_config2_on_the_cpu(config2):
    art = config2
    assert art["docs"] == 1 and art["scaled_bytes"] == 4195292
    cpu, sc = art["cpu_mode"], art["sidecar_mode"]
    assert cpu["upload_retries"] == 0 and cpu["client_conns"] == 4
    # The daemon's own CPU dedup is the referee: the same cuts and
    # digests give the same savings and the same chunk hits.
    assert sc["dedup_bytes_saved"] == cpu["dedup_bytes_saved"] > 0
    hits = [[node.get("store.dedup_hits") for node in
             leg["daemon_stats"]["after"].values()] for leg in (cpu, sc)]
    assert hits[0] == hits[1]
    # rates: the CPU leg's are the daemon's own; none off the card for
    # the sidecar leg
    assert art["daemon_ingest_GBps"] == cpu["daemon_ingest_GBps"] > 0
    assert sc["daemon_ingest_GBps"] is None
    assert art["chunker_py_serial_GBps"] > 0
    assert art["chunker_cpp_GBps"] is None or art["chunker_cpp_GBps"] > 0
    assert sc["sidecar_stats"]["chunks"] == art["chunks_sample"]


def test_config2_first_document_cuts_are_the_references(config2):
    from fastdfs_tpu.ops.gear_cdc import chunk_stream_ref

    doc = ref_bc._text_corpus(1)[0]
    assert config2["chunks_sample"] == len(chunk_stream_ref(doc)) == 645


@pytest.mark.parametrize("leg", ["cpu_mode", "sidecar_mode"])
def test_config2_stage_table(config2, leg):
    """tests/test_bench_configs.py's checks of the reference's table."""
    st = config2[leg]["upload_stages"]
    assert st["count"] >= 1
    assert st["stages_s"]["fp_us"] > 0
    assert st["stages_s"]["cswrite_us"] >= 0
    assert abs(sum(st["stage_share"].values()) - 1.0) < 0.05


def test_config3_on_the_cpu(config3):
    art = config3
    assert art["files"] == 1 and art["scaled_bytes"] == 2359296
    for leg in ("cpu_mode", "sidecar_mode"):
        run = art[leg]
        assert run["files"] == 1 and run["scaled_bytes"] == 2359296
        assert run["sync_recipe_replays"] == run["files"], leg
        assert len(run["dedup_bytes_saved_per_node"]) == 2
        assert run["sync_wire_bytes"] > 0
        for st in run["upload_stages_per_node"]:
            if st is not None:
                assert st["stages_s"]["fp_us"] > 0
                assert abs(sum(st["stage_share"].values()) - 1.0) < 0.05
    assert art["ingest_GBps"] == art["cpu_mode"]["ingest_GBps"] > 0
    assert art["replicated_GBps"] > 0
    sc = art["sidecar_mode"]
    assert sc["ingest_GBps"] is None and sc["replicated_GBps"] is None
