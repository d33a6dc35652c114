"""The port's config 13 (``fastdfs_tpu_torch.bench_configs``), SLO-driven
admission control, on the CPU through ``tests/torch_native.py``'s
daemons and ``fdfs_load``.

It runs once at its default scale, 12 files of 1 MB, the size of the
reference's artifact: a baseline storage (admission off) calibrated and
then offered 1.7x its capacity, and a storage with the ladder on,
offered half and then 1.7x that capacity, each leg a priority-mixed
open-loop download load of the reference's fixed length.  What is held
to the reference is the artifact's keys, at every level: the checked-in
reference artifact's, plus the card line.  The rest holds the port to
those of its own verdicts that do not depend on the host's load;
whether the half-capacity leg sheds, and how far the baseline
collapses, depend on what else the host runs, and are not held.
"""

import json
import os

import pytest

from fastdfs_tpu_torch import bench_configs as bc
from torch_native import same_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = {"interactive", "normal", "background"}
VERDICTS = ("zero_non_shed_errors", "interactive_never_shed")


@pytest.fixture(scope="module")
def config13(tmp_path_factory):
    out = tmp_path_factory.mktemp("port13")
    bc.main(["--config", "13", "--device", "cpu", "--out", str(out)])
    with open(os.path.join(str(out), "config13.json")) as fh:
        return json.load(fh)


def test_config13_keys_are_the_references(config13):
    with open(os.path.join(REPO, "bench_artifacts", "config13.json")) as fh:
        ref = json.load(fh)
    assert set(config13) == set(ref) | {"card"}
    assert config13["card"] is None
    same_keys({k: v for k, v in config13.items() if k != "card"}, ref)


@pytest.mark.parametrize("verdict", VERDICTS)
def test_config13_verdict_holds(config13, verdict):
    assert config13[verdict] is True


def test_config13_sizes_and_thresholds(config13):
    assert config13["files"] == 12 and config13["threads"] == 16
    assert config13["scaled_bytes"] == 12 << 20
    assert (config13["priority_mix"]
            == "interactive:1:0.4,normal:2:0.3,background:4:0.3")
    rates = config13["offered_rates_qps"]
    assert config13["capacity_qps"] > 0
    assert rates["overload"] > rates["half"] > 0
    assert config13["slo_request_p99_threshold_ms"] >= 5.0
    assert config13["slo_loop_lag_threshold_ms"] >= 10


@pytest.mark.parametrize("arm,leg", [("baseline", "overload"),
                                     ("admission", "half"),
                                     ("admission", "overload")])
def test_config13_leg(config13, arm, leg):
    cell = config13["arms"][arm][leg]
    assert set(cell["by_class"]) == CLASSES
    assert cell["non_shed_errors"] == 0
    assert cell["ops"] == sum(c["ops"] for c in cell["by_class"].values())
    assert cell["shed"] == sum(c["shed"] for c in cell["by_class"].values())
    assert cell["by_class"]["interactive"]["shed"] == 0
    if arm == "baseline":
        assert cell["shed"] == 0


def test_config13_gauges_count_the_sheds(config13):
    adm = config13["arms"]["admission"]
    after = adm["gauges_after_overload"]
    assert after["admission.shed_total"] == (adm["half"]["shed"]
                                             + adm["overload"]["shed"])
    assert after["admission.shed.interactive"] == 0
