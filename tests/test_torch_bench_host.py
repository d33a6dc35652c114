"""The port's single-storage configs 1, 6, 7 and 8
(``fastdfs_tpu_torch.bench_configs``) against the reference's root
``bench_configs.py`` on the CPU, through ``tests/torch_native.py``'s
daemons and ``fdfs_load``.

Config 6 runs at its default scale on the client's host route
(``fingerprint_buffer(device="cpu")``: NumPy gear CDC and hashlib) and
must ship the wire bytes of the checked-in reference artifact exactly
(``tests/test_torch_client_fingerprint.py`` holds the card's route to
the reference on config 6's first blob and its edited copy).
Configs 1, 7 and 8 run at their smallest scales.  Each artifact keeps
the checked-in reference artifact's keys (``bench_artifacts/``), plus
the card line and the keys that root ``bench_configs.py`` writes today
and those artifacts predate.
"""

import inspect
import json
import os
import shutil
import subprocess

import pytest

import bench_configs as ref_bc
from fastdfs_tpu_torch import bench_configs as bc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = (1, 6, 7, 8)
# The smallest corpora each config builds: 8 pieces (config 1), 8
# preloaded blobs (config 7), 8 blobs and a 4 MB file (config 8).
SMALLEST = {1: 0.002, 7: 0.0001, 8: 0.0001}
# Keys that the reference's code writes and the checked-in artifacts
# lack (at the top level, or in each of ``modes``), and the keys only
# the port writes.
ADDED = {1: {"phase_wall_s", "daemon_stats"},
         6: {"phase_wall_s", "daemon_stats"}}
ADDED_MODES = {7: {"phase_wall_s", "daemon_stats"},
               8: {"phase_wall_s", "daemon_stats"}}
PORT_ONLY = {1: {"card"}, 6: {"card", "kernel_launches"}, 7: {"card"},
             8: {"card"}}


def _reference_artifact(config: int) -> dict:
    with open(os.path.join(REPO, "bench_artifacts",
                           f"config{config}.json")) as fh:
        return json.load(fh)


def _run(config: int, scale: float, out_dir) -> dict:
    bc.main(["--config", str(config), "--scale", str(scale), "--device",
             "cpu", "--out", str(out_dir)])
    with open(os.path.join(str(out_dir), f"config{config}.json")) as fh:
        return json.load(fh)


class _Built(Exception):
    pass


def _reference_config6_corpus(scale: float, out_dir) -> tuple:
    """The blobs and edited copies that root ``config6`` builds inline,
    taken from its frame when it asks for its cluster (which then
    raises, so no daemon starts)."""
    def cluster(*args, **kw):
        local = inspect.currentframe().f_back.f_locals
        raise _Built(local["corpus"], local["edited"], local["tmp"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_bc, "_cluster", cluster)
        with pytest.raises(_Built) as built:
            ref_bc.config6(str(out_dir), scale)
    corpus, edited, tmp = built.value.args
    shutil.rmtree(tmp, ignore_errors=True)
    return corpus, edited


@pytest.mark.parametrize("scale", [1e-6, 1 / 2000, 1 / 256])
def test_config6_corpus_is_the_references(scale, tmp_path):
    want = _reference_config6_corpus(scale, tmp_path)
    got = bc._config6_corpus(int(bc.NOMINAL[6] * scale))
    assert len(got[0]) == len(got[1]) == len(want[0]) >= 4
    assert got == want
    assert all(a[:len(a) - len(a) // 8] == b[:len(b) - len(b) // 8]
               and a != b for a, b in zip(*got))


@pytest.mark.parametrize("config", NEW)
def test_added_keys_are_the_references(config):
    """Every key the port adds beside the checked-in artifact's, other
    than its own, is one the reference's code writes today."""
    src = inspect.getsource(getattr(ref_bc, f"config{config}"))
    for key in ADDED.get(config, set()) | ADDED_MODES.get(config, set()):
        assert f'"{key}"' in src, key
    for key in PORT_ONLY[config]:
        assert f'"{key}"' not in src, key


@pytest.mark.parametrize("source", ["load_binary", "smoke_build"])
def test_load_binary_is_an_executable(source):
    """``load_binary()`` (the checkout's build where it has one) and the
    smoke build's ``fdfs_load``, which a host without one gets."""
    native = bc._native()
    path = (native.load_binary() if source == "load_binary" else
            native._smoke_build()[0][native.OUTPUTS.index("fdfs_load")])
    assert os.path.basename(path) == "fdfs_load"
    assert os.path.isfile(path) and os.access(path, os.X_OK)
    out = subprocess.run([path], capture_output=True, text=True, timeout=30)
    assert "usage: fdfs_load upload|download" in out.stdout + out.stderr


@pytest.fixture(scope="module")
def config6(tmp_path_factory):
    # The default scale: 160 blobs of 256 KB, three passes.
    return _run(6, bc.DEFAULT_SCALE[6], tmp_path_factory.mktemp("port6"))


@pytest.fixture(scope="module")
def config1(tmp_path_factory):
    return _run(1, SMALLEST[1], tmp_path_factory.mktemp("port1"))


@pytest.fixture(scope="module")
def config7(tmp_path_factory):
    return _run(7, SMALLEST[7], tmp_path_factory.mktemp("port7"))


@pytest.fixture(scope="module")
def config8(tmp_path_factory):
    return _run(8, SMALLEST[8], tmp_path_factory.mktemp("port8"))


@pytest.mark.parametrize("config", NEW)
def test_artifact_keys_are_the_references(config, request):
    art = request.getfixturevalue(f"config{config}")
    ref = _reference_artifact(config)
    assert set(art) == (set(ref) | ADDED.get(config, set())
                        | PORT_ONLY[config])
    if config in ADDED_MODES:
        assert set(art["modes"]) == set(ref["modes"])
        for mode, got in art["modes"].items():
            assert set(got) == set(ref["modes"][mode]) | ADDED_MODES[config]
    if config == 8:
        assert set(art["parallel"]) | {"note"} == set(ref["parallel"])
    assert art["card"] is None


def test_config6_ships_the_references_wire_bytes(config6):
    """The host route at the default scale: the five numbers of
    ``bench_artifacts/config6.json``, exactly."""
    ref = _reference_artifact(6)
    for name in ("cold", "warm", "edited"):
        got = config6[name]
        assert got["wire_bytes_sent"] == ref[name]["wire_bytes_sent"], name
        assert got["files"] == ref[name]["files"] == 160
        assert got["logical_bytes"] == ref[name]["logical_bytes"]
    assert [config6[name]["wire_bytes_sent"]
            for name in ("cold", "warm", "edited")] == [41943040, 0,
                                                       6542419]
    ingest = config6["ingest_counters"]
    assert ingest["ingest.bytes_saved_wire"] == 77343661
    assert ingest["ingest.recipe_uploads"] == 480
    assert ingest["ingest.recipe_fallbacks"] == 0
    assert ingest == ref["ingest_counters"]
    assert config6["warm_pass_ok"] is True
    assert config6["scaled_bytes"] == ref["scaled_bytes"]


def test_config6_host_route_launches_nothing(config6):
    assert config6["kernel_launches"] == {
        "sha1_ragged_cuda.launches": 0, "gear_candidates_cuda.launches": 0,
        "gear_window.cuda_calls": 0, "uploads": 480}
    assert "on the host" in config6["description"]
    assert "CPU-only" not in config6["description"]


@pytest.mark.parametrize("launches,faults", [
    ((480, 480, 0), []),
    ((480, 960, 0), []),
    ((480, 700, 0), []),
    ((479, 480, 0), ["479 SHA-1 launches for 480 uploads"]),
    ((960, 480, 0), ["960 SHA-1 launches for 480 uploads"]),
    ((480, 479, 0), ["479 gear launches for 480 uploads"]),
    ((480, 961, 0), ["961 gear launches for 480 uploads"]),
    ((480, 480, 2), ["2 plain gear passes on the card"]),
])
def test_launch_faults(launches, faults):
    keys = ["sha1_ragged_cuda.launches", "gear_candidates_cuda.launches",
            "gear_window.cuda_calls"]
    assert bc.launch_faults(dict(zip(keys, launches)), 480) == faults


def test_config1_on_the_cpu(config1):
    art = config1
    assert art["errors"] == 0
    assert art["uploads"] == 8 and art["scaled_bytes"] == 8 << 18
    # Half the payloads are distinct: the other half dedups.
    assert art["dedup_bytes_saved"] == art["scaled_bytes"] // 2
    assert art["daemon_ingest_GBps"] > 0 and art["download_GBps"] > 0
    assert art["upload_stages"]["count"] >= art["uploads"]
    assert "no kernel runs" in art["description"]


def test_config7_on_the_cpu(config7):
    art = config7
    modes = art["modes"]
    assert art["no_false_corruption"] is True
    assert art["scrub_verified_ok"] is True
    assert modes["off"]["chunks_verified"] == 0
    assert modes["bw16"]["chunks_verified"] > 0
    assert modes["unlimited"]["chunks_verified"] > 0
    for mode in modes.values():
        assert mode["chunks_corrupt"] == 0
        assert mode["ops"] >= 10
        assert 0 < mode["upload_p50_ms"] <= mode["upload_p99_ms"]


def test_config8_on_the_cpu(config8):
    art = config8
    modes = art["modes"]
    assert art["wrong_bytes"] == 0
    assert art["files"] == 8
    assert modes["cache0"]["cache_hits"] == 0
    assert modes["cache64"]["cache_hits"] > 0
    assert art["warm_cache_hits_at_64"] == modes["cache64"]["cache_hits"]
    for mode in modes.values():
        assert mode["cold"]["downloads"] == mode["warm"]["downloads"] == 8
    par = art["parallel"]
    assert par["file_bytes"] == 4 << 20 and par["range_bytes"] == 1 << 20
    assert par["host_cpus"] == art["host_cpus"] == (os.cpu_count() or 1)
    assert ("note" in par) == (art["host_cpus"] == 1)
