"""The port's bench (``fastdfs_tpu_torch.bench``) against the reference's
root ``bench.py``: its contract without a card (one JSON line, rc 0,
``ok: false``, no value, nothing measured), its rank statistics, its
constants and provenance, and its flagship step on the CPU, where the
kernel wrappers take their plain twins."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as ref_bench
from fastdfs_tpu.ops import minhash as ref_minhash
from fastdfs_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args: list[str], smoke: bool) -> tuple[subprocess.CompletedProcess,
                                                list[str]]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("_FDFS_BENCH_SMOKE", "PYTHONPATH")}
    if smoke:
        env["_FDFS_BENCH_SMOKE"] = "1"
    proc = subprocess.run([sys.executable, "-m", "fastdfs_tpu_torch.bench",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    return proc, [ln for ln in proc.stdout.splitlines() if ln.strip()]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("args,metric", [
    ([], "dedup_ingest_GBps_per_chip"),
    (["--multichip"], "dedup_ingest_GBps_multichip"),
], ids=["flagship", "multichip"])
def test_without_a_card_one_line_not_ok(args, metric, smoke):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    proc, lines = _run(args, smoke)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out["ok"] is False
    assert out["value"] is None
    assert out["metric"] == metric
    assert "CUDA is not available" in out["error"]
    assert out["smoke"] is smoke
    assert out["n_devices"] == 0 and out["card"] is None
    # No CPU number stands in for the card's.
    for key in ("rounds", "dispersion", "vs_baseline", "cpu_baseline_GBps",
                "aggregate_GBps", "legs"):
        assert key not in out


def _reference_stats(rates: list[float]) -> dict:
    """bench.py:170-188 and :206-210, the reference's formulas as written
    inline in ``_bench_tpu``."""
    srt = sorted(rates)
    n = len(srt)
    median = srt[n // 2]
    q1, q3 = srt[n // 4], srt[(3 * n) // 4]
    spread = (srt[-1] - srt[0]) / median if median else 0.0
    contended = spread > ref_bench.CONTENTION_SPREAD
    out = {
        "value": round(median, 4),
        "rounds": n,
        "dispersion": {
            "min": round(srt[0], 4),
            "median": round(median, 4),
            "max": round(srt[-1], 4),
            "iqr_rel": round((q3 - q1) / median, 4) if median else 0.0,
            "spread_rel": round(spread, 4),
        },
        "contended": contended,
        "contention_rule": f"(max-min)/median > {ref_bench.CONTENTION_SPREAD}",
    }
    if contended:
        upper = srt[n // 2:]
        out["value_uncontended"] = round(upper[len(upper) // 2], 4)
    return out


RATE_CASES = {
    "steady_7": [301.2, 299.8, 300.5, 302.0, 298.9, 300.1, 300.7],
    "steady_15": [250.0 + 0.37 * i for i in range(15)],
    "contended_7": [8.34, 3.35, 7.9, 8.1, 4.2, 8.0, 7.7],
    "contended_15": [5.0 + (i % 5) * 0.9 for i in range(15)],
    "one_slow_round": [100.0, 100.5, 99.8, 100.2, 60.0, 100.1, 100.3, 99.9],
    "two_rounds": [10.0, 14.0],
    "edge_of_rule": [100.0, 100.0, 130.0],
    "just_past_rule": [100.0, 100.0, 130.01],
    "zero_median": [0.0, 0.0, 1.0, 0.0],
}


@pytest.mark.parametrize("name", sorted(RATE_CASES))
def test_rank_stats_match_the_reference(name):
    rates = RATE_CASES[name]
    got = bench.rank_stats(rates)
    want = _reference_stats(rates)
    assert got == want
    assert ("value_uncontended" in got) == got["contended"]


def test_rank_stats_cases_cover_both_sides_of_the_rule():
    flags = {bench.rank_stats(r)["contended"] for r in RATE_CASES.values()}
    assert flags == {True, False}


def test_constants_match_the_reference():
    for name in ("CHUNK_KB", "N_CHUNKS", "PIPELINE", "MIN_ROUNDS",
                 "MAX_ROUNDS", "MIN_SECONDS", "CONTENTION_SPREAD"):
        assert getattr(bench, name) == getattr(ref_bench, name), name
    assert bench._SMOKE is ref_bench._SMOKE


_CONSTANTS = r"""
import json, bench as ref, fastdfs_tpu_torch.bench as port
names = ("CHUNK_KB", "N_CHUNKS", "PIPELINE", "MIN_ROUNDS", "MAX_ROUNDS",
         "MIN_SECONDS", "CONTENTION_SPREAD", "_SMOKE")
print(json.dumps([[getattr(ref, n) for n in names],
                  [getattr(port, n) for n in names]]))
"""


def test_smoke_constants_match_the_reference():
    env = dict(os.environ, _FDFS_BENCH_SMOKE="1")
    out = subprocess.run([sys.executable, "-c", _CONSTANTS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    ref, port = json.loads(out.stdout)
    assert ref == port
    assert port[-1] is True and port[1] == 32


def test_provenance_holds_the_reference_keys():
    ref = ref_bench._provenance()
    got = bench._provenance()
    assert set(ref) <= set(got)
    assert got["cdc_policy"] == ref["cdc_policy"]
    assert got["smoke"] == ref["smoke"]
    assert got["host_cpus"] == ref["host_cpus"]
    assert got["backend"] == "cuda"
    assert got["n_devices"] == torch.cuda.device_count()
    assert "card" in got


def test_flagship_data_is_the_references():
    chunks, lens = bench.flagship_data(8)
    rng = np.random.RandomState(0)
    want = rng.randint(0, 256, size=(8, bench.CHUNK_KB * 1024),
                       dtype=np.uint8)
    assert np.array_equal(chunks, want)
    assert lens.dtype == np.int32
    assert (lens == bench.CHUNK_KB * 1024).all()


@pytest.fixture(scope="module")
def smoke_step():
    """The flagship step on the CPU at the smoke size (32 rows of 64 KiB),
    its outputs, and the reference's signatures of the same rows."""
    chunks, lens = bench.flagship_data(32)
    digests, sigs = bench.fingerprint_step(torch.from_numpy(chunks),
                                           torch.from_numpy(lens))
    ref_sigs = np.asarray(ref_minhash.minhash_batch(chunks, lens))
    return chunks, lens, digests, sigs, ref_sigs


def test_flagship_step_on_the_cpu_matches_hashlib_and_the_reference(
        smoke_step):
    chunks, lens, digests, sigs, ref_sigs = smoke_step
    assert digests.dtype == torch.uint32 and digests.shape == (32, 5)
    assert sigs.dtype == torch.uint32 and sigs.shape == (32, 64)
    raw = digests.view(torch.int32).numpy().astype(">u4").tobytes()
    want = b"".join(hashlib.sha1(row.tobytes()).digest() for row in chunks)
    assert raw == want
    assert np.array_equal(sigs.view(torch.int32).numpy().view(np.uint32),
                          ref_sigs)


def test_check_rows_accepts_the_steps_outputs(smoke_step):
    chunks, lens, digests, sigs, _ = smoke_step
    assert bench.check_rows(chunks, lens, digests, sigs) == {
        "digest_rows": 32, "digests_equal": True, "sig_rows": bench.SIG_ROWS,
        "sigs_equal": True}


@pytest.mark.parametrize("which", ["digest", "signature"])
def test_check_rows_finds_a_flipped_bit(smoke_step, which):
    chunks, lens, digests, sigs, _ = smoke_step
    digests = digests.view(torch.int32).clone()
    sigs = sigs.view(torch.int32).clone()
    if which == "digest":
        digests[3, 2] ^= 1 << 7
    else:
        sigs[bench.SIG_ROWS - 1, 63] ^= 1
    got = bench.check_rows(chunks, lens, digests.view(torch.uint32),
                           sigs.view(torch.uint32))
    assert got["digests_equal"] is (which != "digest")
    assert got["sigs_equal"] is (which != "signature")
