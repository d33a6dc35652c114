"""The port's configs 4 and 5 (``fastdfs_tpu_torch.bench_configs``)
against the reference's root ``bench_configs.py``: the same corpus and
referee byte for byte, the same recall, classes, counts and agreement
from config 4 on the CPU, and config 5's artifact shapes with eight CPU
ranks; the sizes of configs 1-14, each refusing ``cuda`` without a card
(configs 1-3 and 6-14 before any daemon; their runs are in
``tests/test_torch_bench_daemon.py``, ``tests/test_torch_bench_host.py``,
``tests/test_torch_bench_slab.py``, ``tests/test_torch_bench_groups.py``,
``tests/test_torch_bench_edge.py``, ``tests/test_torch_bench_admission.py``
and ``tests/test_torch_bench_hot.py``), and ``main``'s choice of configs
and scales against the reference's."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import bench_configs as ref_bc
from fastdfs_tpu_torch import bench_configs as bc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ~2 MB, 32 documents, as tests/test_bench_configs.py; and 294
# documents, two streamed batches (256 + 38).
SCALES4 = (0.00002, 0.00018)


@pytest.mark.parametrize("total,seed", [
    (2 << 20, 4), (3 << 20, 4), (5 << 20, 4), (2 << 20, 0), (4 << 20, 11),
])
def test_html_corpus_is_the_references(total, seed):
    got = bc._html_corpus(total, seed=seed)
    want = ref_bc._html_corpus(total, seed=seed)
    for name, a, b in zip(("docs", "lens", "truth", "klass"), got, want):
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("n_docs,num_perms,shingle", [
    (2, 16, 5), (4, 64, 5), (3, 128, 5), (5, 64, 4), (2, 7, 3),
])
def test_textbook_minhash_is_the_references(n_docs, num_perms, shingle):
    rng = np.random.RandomState(n_docs * 1000 + num_perms)
    docs = rng.randint(0, 256, size=(n_docs, 4096), dtype=np.uint8)
    lens = rng.randint(shingle, 4097, size=n_docs).astype(np.int32)
    lens[0] = 4096
    got = bc._textbook_minhash(docs, lens, num_perms, shingle)
    want = ref_bc._textbook_minhash(docs, lens, num_perms, shingle)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("config", range(1, 15))
def test_sizes_are_the_references(config):
    assert bc.NOMINAL[config] == ref_bc.NOMINAL[config]
    assert bc.DEFAULT_SCALE[config] == ref_bc.DEFAULT_SCALE[config]


def _record(calls, config, out_dir, scale, *device):
    calls.append((config, scale))


# Command lines and the (config, scale) calls the port's ``main`` makes
# for them: ``--full`` runs the nominal size and beats ``--scale``, and
# ``--config 0`` or none runs every config in order.
ALL_DEFAULTS = [(c, bc.DEFAULT_SCALE[c]) for c in range(1, 15)]
MAIN_CASES = [
    (["--config", "4", "--full"], [(4, 1.0)]),
    (["--config", "0"], ALL_DEFAULTS),
    ([], ALL_DEFAULTS),
    (["--full"], [(c, 1.0) for c in range(1, 15)]),
    (["--config", "9", "--scale", "0.5", "--full"], [(9, 1.0)]),
    (["--config", "0", "--scale", "0.125"],
     [(c, 0.125) for c in range(1, 15)]),
    (["--config", "11"], [(11, 1 / 256.0)]),
    (["--config", "14"], [(14, 1 / 64.0)]),
]


@pytest.mark.parametrize("argv,want", MAIN_CASES,
                         ids=[" ".join(a) or "none" for a, _ in MAIN_CASES])
def test_main_runs_what_the_references_runs(argv, want, monkeypatch):
    """Each config the port's ``main`` calls, at the scale root ``main``
    gives the same config on the same command line."""
    port, ref = [], []
    for c in bc.CONFIGS:
        monkeypatch.setitem(bc.CONFIGS, c, functools.partial(_record, port, c))
    for c in range(1, 15):
        monkeypatch.setattr(ref_bc, f"config{c}",
                            functools.partial(_record, ref, c))
    monkeypatch.setattr(sys, "argv", ["bench_configs.py", *argv])
    ref_bc.main()
    bc.main(argv)
    assert port == want
    assert port == [(c, s) for c, s in ref if c in bc.CONFIGS]


def test_default_out_is_ignored_and_not_the_references():
    assert os.path.dirname(bc.DEFAULT_OUT) == REPO
    assert os.path.basename(bc.DEFAULT_OUT) == "bench_torch_out"
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "bench_torch_out/" in fh.read().split()


@pytest.mark.parametrize("config", range(1, 15))
def test_configs_refuse_cuda_without_a_card(config, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")

    def no_daemons():
        raise AssertionError("a daemon was looked up before the device")

    monkeypatch.setattr(bc, "_native", no_daemons)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bc.CONFIGS[config](str(tmp_path), bc.DEFAULT_SCALE[config])
    assert not os.listdir(tmp_path)


# Fields of config 4's artifact that do not depend on where it ran.
C4_SAME = ("nominal_bytes", "scaled_bytes", "docs", "bases", "queries",
           "distractors", "recall_at_1_vs_truth", "recall_at_5_vs_truth",
           "recall_per_class", "recall_target", "recall_pass",
           "referee_queries", "referee_top1_agreement_acc_vs_textbook",
           "referee_textbook_recall_at_1", "description", "config")


@pytest.fixture(scope="module", params=SCALES4)
def config4_pair(request, tmp_path_factory):
    """Config 4 at a scale of SCALES4 from the reference and from the
    port's command line on the CPU."""
    ref_dir = tmp_path_factory.mktemp("ref4")
    port_dir = tmp_path_factory.mktemp("port4")
    ref_bc.config4(str(ref_dir), scale=request.param)
    bc.main(["--config", "4", "--scale", str(request.param), "--device",
             "cpu", "--out", str(port_dir)])
    arts = []
    for d in (ref_dir, port_dir):
        with open(os.path.join(str(d), "config4.json")) as fh:
            arts.append(json.load(fh))
    return arts


@pytest.mark.parametrize("key", C4_SAME)
def test_config4_on_the_cpu_matches_the_reference(config4_pair, key):
    ref, port = config4_pair
    assert port[key] == ref[key]


def test_config4_on_the_cpu_reports_no_card_numbers(config4_pair):
    ref, port = config4_pair
    assert ref["kernel_bitexact_pallas_vs_xla"] is None
    assert port["kernel_bitexact_cuda_vs_plain"] is None
    assert "kernel_bitexact_pallas_vs_xla" not in port
    assert port["backend"] == "cpu" and port["card"] is None
    assert port["accelerated_sig_GBps_streamed"] is None
    assert port["accelerated_sig_GBps_resident"] is None
    assert port["batches"] == -(-port["docs"] // bc.BATCH)
    assert port["distractors"] > 0
    assert port["recall_at_1_vs_truth"] >= 0.98
    assert set(ref) - {"kernel_bitexact_pallas_vs_xla"} <= set(port)


def test_config5_on_the_cpu_has_the_references_shapes(tmp_path):
    art = bc.config5(str(tmp_path), bc.DEFAULT_SCALE[5], device="cpu")
    with open(os.path.join(str(tmp_path), "config5.json")) as fh:
        assert json.load(fh) == art
    with open(os.path.join(REPO, "bench_artifacts", "config5.json")) as fh:
        ref = json.load(fh)
    for key in ("digests_shape", "sigs_shape", "mesh", "iterations",
                "scaled_bytes", "nominal_bytes", "best_sim_finite",
                "description"):
        assert art[key] == ref[key], key
    assert art["best_shape"] == [32]
    assert art["candidates_shape"] == [8, 2, 8192]
    assert art["backend"] == "cpu"
    assert art["seconds"] is None and art["aggregate_GBps"] is None
