"""The check decides ``correct``: a sound run passes it, and each fault
this cell can have fails it, as does the control.  Each run here skips
the look for a card and drives the rest of a run on the CPU, at small
segments, with the engine's kernels replaced by the reference."""

import pytest
import torch

import fastdfs_tpu_torch.dedup.engine as engine_mod
import pb_cpu
from portbench import control

CELLS = ["node_text_cdc.seg64", "group_bin_sha1.seg64"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(monkeypatch, name):
    pb_cpu.patch_kernels(monkeypatch)
    cell = pb_cpu.small_cell(name)
    res = pb_cpu.run_cpu(cell, 2 ** 31 + 5)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}


def test_traced_run_reads_the_per_layer_metrics(monkeypatch):
    pb_cpu.patch_kernels(monkeypatch)
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[0]), 7, traced=True)
    assert res["correct"]
    # No card: only the host's span reads; the device's readers find
    # nothing and leave their metrics out.
    assert set(res["metrics"]) == {"engine.call_p50_ms", "engine.call_p95_ms"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_state_left_unchanged_fails(monkeypatch):
    """Each call returns the answer of the call before it."""
    pb_cpu.patch_kernels(monkeypatch)
    real = engine_mod.DedupEngine.fingerprint
    last = {}

    def stale(self, data, cuts=None):
        out = real(self, data, cuts)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(engine_mod.DedupEngine, "fingerprint", stale)
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[0]), 11)
    assert not res["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    """The segment's second half of chunks is never fingerprinted."""
    pb_cpu.patch_kernels(monkeypatch)
    real = engine_mod.DedupEngine._fingerprint_segment

    def half(self, data, offsets, lens):
        keep = max(1, len(lens) // 2)
        return real(self, data, offsets[:keep], lens[:keep])

    monkeypatch.setattr(engine_mod.DedupEngine, "_fingerprint_segment", half)
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[1]), 12)
    assert not res["correct"]
    assert res["checks"]["digests_wrong"]["value"] > 0
    # Every call, sampled or not, is held to its rows.
    assert res["checks"]["chunk_counts_wrong"]["value"] == res["attempted"]


@pytest.mark.parametrize("cut", ["last_row", "last_permutation"])
def test_a_short_answer_fails_on_every_call(monkeypatch, cut):
    """The signatures lose their last row, or their last permutation, on
    every call: each call is caught by its rows, not only the sample."""
    pb_cpu.patch_kernels(monkeypatch)
    real = engine_mod.DedupEngine.fingerprint

    def short(self, data, cuts=None):
        spans, digests, sigs = real(self, data, cuts)
        return spans, digests, (sigs[:-1] if cut == "last_row"
                                else sigs[:, :-1])

    monkeypatch.setattr(engine_mod.DedupEngine, "fingerprint", short)
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[0]), 15)
    assert not res["correct"]
    assert res["checks"]["chunk_counts_wrong"]["value"] == res["attempted"]


@pytest.mark.parametrize("where", ["digest", "signature"])
def test_answer_altered_where_produced_fails(monkeypatch, where):
    """One bit of one chunk's digest or signature, flipped in the kernel's
    output."""
    def flip(stand_in):
        def altered(*args, **kw):
            out = stand_in(*args, **kw).view(torch.int32)
            out[len(out) // 2, 0] ^= 1
            return out.view(torch.uint32)
        return altered

    if where == "digest":
        pb_cpu.patch_kernels(monkeypatch, sha1=flip(pb_cpu.sha1_stand_in))
    else:
        pb_cpu.patch_kernels(monkeypatch, sketch=flip(pb_cpu.sketch_stand_in))
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[0]), 13)
    assert not res["correct"]
    key = "digests_wrong" if where == "digest" else "sigs_wrong"
    assert res["checks"][key]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in the engine's place with the sketch's sample one
    bit coarser: exact digests, wrong signatures."""
    cell = pb_cpu.small_cell(name)
    res = pb_cpu.run_cpu(cell, 2 ** 32 + 3,
                         system=control.ControlEngine(5, 64))
    assert not res["correct"]
    assert res["checks"]["digests_wrong"]["value"] == 0
    assert res["checks"]["sigs_wrong"]["value"] > 0


def test_a_call_that_raises_fails_without_hanging(monkeypatch):
    pb_cpu.patch_kernels(monkeypatch)
    real = engine_mod.DedupEngine.fingerprint
    calls = []

    def flaky(self, data, cuts=None):
        calls.append(1)
        if len(calls) % 7 == 0:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(self, data, cuts)

    monkeypatch.setattr(engine_mod.DedupEngine, "fingerprint", flaky)
    res = pb_cpu.run_cpu(pb_cpu.small_cell(CELLS[0]), 14)
    assert not res["correct"]
    assert res["checks"]["calls_failed"]["value"] > 0
