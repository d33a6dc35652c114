"""The port's config 9 (``fastdfs_tpu_torch.bench_configs``) and index
tool (``fastdfs_tpu_torch.tools.bench_index_scale``) against the
reference's root ``bench_configs.py`` and ``tools/bench_index_scale.py``
on the CPU.

Config 9 runs once at its smallest corpus (200 files of 4 KB a layout
arm) through ``tests/torch_native.py``'s daemons and ``fdfs_load``: its
artifact keeps the checked-in reference artifact's keys, plus the card
line, and its correctness verdicts hold.  The index tool runs at 20,000
entries, and the port's ``ExactDigestIndex`` answers as the reference's
does on the tool's own seeded digests.
"""

import json
import os

import numpy as np
import pytest

from fastdfs_tpu.dedup.index import ExactDigestIndex as RefIndex
from fastdfs_tpu_torch import bench_configs as bc
from fastdfs_tpu_torch.dedup.index import ExactDigestIndex
from fastdfs_tpu_torch.tools import bench_index_scale as bis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE9 = 1 / 2048   # 200 files of 4 KB a layout arm, the smallest corpus
# Keys of fdfs_load's summaries that the load driver writes today and
# the checked-in artifacts predate.
LOAD_ADDED = {"by_class", "shed"}


def _reference_artifact(name: str) -> dict:
    with open(os.path.join(REPO, "bench_artifacts", name)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def config9(tmp_path_factory):
    out = tmp_path_factory.mktemp("port9")
    bc.main(["--config", "9", "--scale", str(SCALE9), "--device", "cpu",
             "--out", str(out)])
    with open(os.path.join(str(out), "config9.json")) as fh:
        return json.load(fh)


def test_load_added_keys_are_the_load_drivers():
    with open(os.path.join(REPO, "native", "tools", "load_cli.cc")) as fh:
        src = fh.read()
    for key in LOAD_ADDED:
        assert f'"{key}"' in src or f'\\"{key}\\"' in src, key


def test_config9_keys_are_the_references(config9):
    ref = _reference_artifact("config9.json")
    assert set(config9) == set(ref) | {"card"}
    assert config9["card"] is None
    assert set(config9["modes"]) == set(ref["modes"]) == {"flat", "packed"}
    for name, mode in config9["modes"].items():
        want = ref["modes"][name]
        assert set(mode) == set(want)
        assert set(mode["slab"]) == set(want["slab"])
        for phase in ("ingest", "download"):
            assert set(mode[phase]) == set(want[phase]) | LOAD_ADDED
    heavy, want = config9["delete_heavy"], ref["delete_heavy"]
    assert set(heavy) == set(want)
    assert (set(heavy["survivor_download"])
            == set(want["survivor_download"]) | LOAD_ADDED)


@pytest.mark.parametrize("verdict", ["inode_win_10x",
                                     "compaction_reclaims_80pct"])
def test_config9_verdict_holds(config9, verdict):
    assert config9[verdict] is True


@pytest.mark.parametrize("mode", ["flat", "packed"])
def test_config9_downloads_every_byte(config9, mode):
    download = config9["modes"][mode]["download"]
    assert download["errors"] == 0
    assert download["ops"] == config9["files"] == 200
    assert download["bytes"] == config9["scaled_bytes"] == 200 * 4096
    assert config9["modes"][mode]["ingest"]["errors"] == 0


def test_config9_compacts_without_a_wrong_byte(config9):
    heavy = config9["delete_heavy"]
    assert config9["wrong_bytes"] == 0
    assert heavy["deleted_files"] == 160 and heavy["delete_errors"] == 0
    assert heavy["compactions"] >= 1 and heavy["reclaim_pct"] >= 80.0
    assert heavy["byte_checks_during_compaction"] >= 20
    survivors = heavy["survivor_download"]
    assert survivors["errors"] == 0 and survivors["bytes"] == 40 * 4096


def test_config9_layouts(config9):
    """The reference smoke test's checks: the packed arm keeps slab
    records where the flat arm keeps files."""
    flat, packed = config9["modes"]["flat"], config9["modes"]["packed"]
    assert flat["slab"]["files"] == 0
    assert packed["slab"]["files"] >= 1
    assert packed["slab"]["slots_live"] >= 400  # a chunk and a recipe a file
    assert config9["files_on_disk_delta_flat"] >= 10 * max(
        config9["files_on_disk_delta_packed"], 1)
    assert config9["inode_delta_flat"] >= 400
    assert config9["threads"] == min(os.cpu_count() or 1, 4)


def test_index_tool_keys_are_the_references(tmp_path):
    out = tmp_path / "index_scale.json"
    assert bis.main(["--n", "20000", "--out", str(out)]) == 0
    with open(out) as fh:
        art = json.load(fh)
    ref = _reference_artifact("index_scale.json")
    assert set(art) == set(ref) | {"card"}
    assert art["card"] is None
    assert art["entries"] == 20000
    assert art["note"] == ref["note"]
    assert art["snapshot_mb"] > 0 and art["inserts_per_sec"] > 0


def test_index_tool_defaults_are_the_references():
    assert os.path.relpath(bis.DEFAULT_OUT, REPO) == os.path.join(
        "bench_torch_out", "index_scale.json")
    assert (bis.SEED, bis.INSERT_BATCH, bis.LOOKUPS, bis.MISSES,
            bis.REMOVE_EVERY) == (42, 100_000, 1_000_000, 1000, 1000)


def _tool_sequence(cls, keys: np.ndarray):
    """The index tool's inserts, removals and merge on ``cls``."""
    idx = cls()
    for i in range(len(keys)):
        idx.insert(bytes(keys[i]), [f"f{i % 1000}", i])
    for i in range(0, len(keys), bis.REMOVE_EVERY):
        idx.remove(bytes(keys[i]))
    idx._merge()
    return idx


@pytest.mark.parametrize("n", [3001, 20000])
def test_index_answers_as_the_references(n, tmp_path):
    rng = np.random.RandomState(bis.SEED)
    keys = bis.digests(n, rng)
    port = _tool_sequence(ExactDigestIndex, keys)
    ref = _tool_sequence(RefIndex, keys)
    assert len(port) == len(ref) == n - len(range(0, n, bis.REMOVE_EVERY))
    # Hits as the tool draws them, every removed digest, and misses.
    hits = [bytes(keys[i]) for i in rng.randint(0, n, 2000)]
    removed = [bytes(keys[i]) for i in range(0, n, bis.REMOVE_EVERY)]
    misses = [bytes(rng.randint(0, 256, 20, dtype=np.uint8))
              for _ in range(200)]
    probes = hits + removed + misses
    assert port.lookup_batch(probes) == ref.lookup_batch(probes)
    assert [port.lookup(d) for d in probes] == [ref.lookup(d)
                                               for d in probes]
    assert all(port.lookup(d) is None for d in removed + misses)
    path = str(tmp_path / "exact")
    port.save(path)
    for loaded in (ExactDigestIndex.load(path), RefIndex.load(path)):
        assert len(loaded) == len(port)
        assert loaded.lookup_batch(probes) == port.lookup_batch(probes)
    assert sorted(ExactDigestIndex.load(path).items()) == sorted(port.items())
