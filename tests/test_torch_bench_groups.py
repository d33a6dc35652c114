"""The port's configs 10 and 11 (``fastdfs_tpu_torch.bench_configs``)
against the reference's root ``bench_configs.py`` on the CPU, through
``tests/torch_native.py``'s daemons and ``fdfs_load``.

Each runs once at its smallest corpus: config 10 on 60 files of 64 KB
(one group, then three behind a placement-mode tracker, then a drain),
config 11 on 12 files of 256 KB (a two-member group demoted to RS(3, 2)
stripes, then two single-node rebuilds).  Each artifact keeps the
checked-in reference artifact's keys, plus the card line, and its
correctness verdicts hold.
"""

import json
import os

import pytest

from fastdfs_tpu_torch import bench_configs as bc
from torch_native import same_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The smallest corpora: 60 files of 64 KB (config 10), 12 of 256 KB (11).
SMALLEST = {10: 1 / 65536, 11: 1 / 65536}
# Keys of fdfs_load's summaries that the load driver writes today and
# the checked-in artifacts predate (tests/test_torch_bench_slab.py finds
# them in its source).
LOAD_ADDED = {"by_class", "shed"}
VERDICTS = {10: ("zero_errors", "three_group_spread_within_10pct",
                 "drain_relocated_all"),
            11: ("replication_near_2x", "efficiency_pass",
                 "zero_wrong_bytes", "reconstruct_from_parity_only")}


def _reference_artifact(config: int) -> dict:
    with open(os.path.join(REPO, "bench_artifacts",
                           f"config{config}.json")) as fh:
        return json.load(fh)


def _run(config: int, out_dir) -> dict:
    bc.main(["--config", str(config), "--scale", str(SMALLEST[config]),
             "--device", "cpu", "--out", str(out_dir)])
    with open(os.path.join(str(out_dir), f"config{config}.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def config10(tmp_path_factory):
    return _run(10, tmp_path_factory.mktemp("port10"))


@pytest.fixture(scope="module")
def config11(tmp_path_factory):
    # Under load a storage's admission ladder sheds background traffic:
    # a peer's replication, which the daemon's sync sender never retries
    # (native/storage/sync.cc; the wait for both members' chunks would
    # time out), and a peer's FETCH_CHUNK of a released chunk, which
    # cuts the client's EC download mid-body (native/storage/server.cc,
    # "missing chunk ... mid-download"; 3 of 8 runs at 1/256 on an
    # 8-core CPU host).
    # Config 3's test and the cluster tests run without the ladder too.
    # The benchmark itself keeps the reference's settings.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "HB", bc.HB + "\nadmission_control = 0")
        return _run(11, tmp_path_factory.mktemp("port11"))


def test_config10_keys_are_the_references(config10):
    ref = _reference_artifact(10)
    assert set(config10) == set(ref) | {"card"}
    assert config10["card"] is None
    same_keys({k: v for k, v in config10.items() if k != "card"}, ref,
              LOAD_ADDED, ("/preload", "/open_download"))


def test_config11_keys_are_the_references(config11):
    ref = _reference_artifact(11)
    assert set(config11) == set(ref) | {"card"}
    assert config11["card"] is None
    assert set(config11["reconstruction"]) == {"unpaced", "paced"}
    same_keys({k: v for k, v in config11.items() if k != "card"}, ref)


@pytest.mark.parametrize("config,verdict",
                         [(c, v) for c in VERDICTS for v in VERDICTS[c]])
def test_verdict_holds(config, verdict, request):
    art = request.getfixturevalue(f"config{config}")
    assert art[verdict] is True


def test_config10_arms(config10):
    arms = config10["arms"]
    assert config10["files"] == 60 and config10["open_loop_ops"] == 120
    assert config10["offered_rate_qps"] > 0
    assert arms["one_group"]["groups"] == 1
    assert arms["one_group"]["group_spread"] == {"group1": 60}
    assert arms["three_groups"]["groups"] == 3
    assert sum(arms["three_groups"]["group_spread"].values()) == 60
    for arm in arms.values():
        assert arm["preload"]["ops"] == 60
        assert arm["open_download"]["ops"] == 120
    drain = arms["three_groups"]["drain"]
    assert drain["files_moved"] >= 1 and drain["pace_mb_s"] > 0
    assert drain["bandwidth_budget_mb_s"] == 8


def test_config11_replicates_twice_then_stripes(config11):
    group = config11["group"]
    assert group["files"] == 12
    assert group["logical_bytes"] == config11["scaled_bytes"] == 12 << 18
    assert group["replicated_physical_bytes"] == 2 * group["logical_bytes"]
    assert group["ec_physical_over_logical"] <= config11["ec_overhead_bound"]
    assert group["released_chunks"] >= 1
    for name in ("replicated_download", "ec_download"):
        assert group[name]["ops"] == 48 and group[name]["wrong"] == 0


@pytest.mark.parametrize("arm", ["unpaced", "paced"])
def test_config11_rebuilds_from_parity(config11, arm):
    r = config11["reconstruction"][arm]
    assert r["bandwidth_budget_mb_s"] == (0 if arm == "unpaced" else 2)
    assert r["stripes"] >= 1 and r["shards_rebuilt"] >= r["stripes"] * 2
    assert r["rebuilt_bytes"] > 0 and r["wall_s"] > 0
    assert r["repair_fallback_chunks"] == 0 and r["wrong_bytes_after"] == 0
