"""The port's DedupEngine (fastdfs_tpu_torch.dedup) against the JAX
package's engine, both on the CPU: spans, digests, signatures, ingest
verdicts and near-dups, and index snapshots loaded across packages in
both directions.

Tolerance: exact equality (integer digests and signatures; near-dup
scores are the same float32 means of the same integer comparisons).
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from fastdfs_tpu.dedup import DedupConfig as JConfig
from fastdfs_tpu.dedup import DedupEngine as JEngine
from fastdfs_tpu.dedup import engine as jengine
from fastdfs_tpu_torch.dedup import DedupConfig, DedupEngine
from fastdfs_tpu_torch.dedup import engine as tengine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# A 32-row tile keeps the plain CPU path cheap; results are per chunk and
# do not depend on the tile (the multi-tile test also checks 16 rows
# against the default 256).
GEO = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)


def _rand(rng, n):
    return rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


def _edited(data: bytes, rng, n_edits: int) -> bytes:
    b = bytearray(data)
    for pos in rng.randint(0, len(b) - 8, size=n_edits):
        b[pos:pos + 8] = rng.randint(0, 256, 8, dtype=np.uint8).tobytes()
    return bytes(b)


def _engines(**extra):
    return (DedupEngine(DedupConfig(**GEO, **extra), device="cpu"),
            JEngine(JConfig(**GEO, **extra)))


def _records(report):
    return [(c.offset, c.length, c.digest, c.duplicate, c.dup_of)
            for c in report.chunks]


def _same_report(a, b):
    assert (a.file_ref, a.size) == (b.file_ref, b.size)
    assert _records(a) == _records(b)
    assert np.array_equal(a.file_signature, b.file_signature)
    assert a.near_dups == b.near_dups


def test_config_fields_and_defaults_match_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(DedupConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert ours == ref


@pytest.mark.parametrize("n", [0, 1, 63, 64, 1025, 4096])
def test_bucket_len_matches_reference(n):
    for geo in ((64, 1024), (2048, 65536)):
        assert tengine._bucket_len(n, *geo) == jengine._bucket_len(n, *geo)


def test_fingerprint_matches_reference():
    data = _rand(np.random.RandomState(1), 20_000)
    ours, ref = _engines()
    spans, digests, sigs = ours.fingerprint(data)
    r_spans, r_digests, r_sigs = ref.fingerprint(data)
    assert spans == r_spans
    assert digests.dtype == np.uint32 and sigs.dtype == np.uint32
    assert np.array_equal(digests, r_digests)
    assert np.array_equal(sigs, r_sigs)
    raw = digests.astype(">u4").tobytes()
    for i, (off, ln) in enumerate(spans):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(data[off:off + ln]).digest()


def test_fingerprint_with_caller_cuts_matches_reference():
    data = _rand(np.random.RandomState(2), 9000)
    cuts = [100, 1500, 1501, 4000, 9000]  # one chunk past max_size
    ours, ref = _engines()
    got, want = ours.fingerprint(data, cuts=cuts), ref.fingerprint(data, cuts=cuts)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    assert ours.fingerprint(b"")[0] == []


def test_multi_tile_staging_reuse_matches_hashlib():
    # A tiny row tile spreads the chunks over many tiles per bucket, so
    # both staging slots of a bucket are reused many times.
    cfg = DedupConfig(**{**GEO, "row_tile": 16})
    data = _rand(np.random.RandomState(7), 60_000)
    spans, digests, sigs = DedupEngine(cfg, device="cpu").fingerprint(data)
    assert -(-len(spans) // 16) > 4
    raw = digests.astype(">u4").tobytes()
    for i, (off, ln) in enumerate(spans):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(data[off:off + ln]).digest()
    ref = DedupEngine(DedupConfig(**{**GEO, "row_tile": 256}),
                      device="cpu").fingerprint(data)
    assert np.array_equal(sigs, ref[2])


def test_ingest_reports_match_reference():
    rng = np.random.RandomState(3)
    a = _rand(rng, 30_000)
    b = _edited(a, rng, 6)
    ours, ref = _engines()
    for data, name in ((a, "f1"), (a, "f2"), (b, "f3"), (a + a[:5000], "f4")):
        _same_report(ours.ingest(data, name), ref.ingest(data, name))
    dry = _rand(rng, 8000)
    _same_report(ours.ingest(dry, "dry", update_index=False),
                 ref.ingest(dry, "dry", update_index=False))
    assert len(ours.exact) == len(ref.exact)
    assert len(ours.near) == len(ref.near)


def test_other_shingle_width_matches_reference():
    data = _rand(np.random.RandomState(4), 6000)
    geo = dict(min_size=64, avg_bits=8, max_size=128, shingle=4, row_tile=32)
    ours = DedupEngine(DedupConfig(**geo), device="cpu").fingerprint(data)
    ref = JEngine(JConfig(**geo)).fingerprint(data)
    assert ours[0] == ref[0]
    assert np.array_equal(ours[2], ref[2])


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_snapshot_cross_load(tmp_path, direction):
    rng = np.random.RandomState(5)
    a = _rand(rng, 20_000)
    b = _edited(a, rng, 4)
    exact_p, near_p = str(tmp_path / "exact"), str(tmp_path / "near")
    ours, ref = _engines()
    writer, reader_cls = ((ours, JEngine) if direction == "port_to_reference"
                          else (ref, DedupEngine))
    writer.ingest(a, "fa")
    writer.save(exact_p, near_p)
    if reader_cls is DedupEngine:
        reader = DedupEngine.load(exact_p, near_p, DedupConfig(**GEO),
                                  device="cpu")
    else:
        reader = JEngine.load(exact_p, near_p, JConfig(**GEO))
    # The next ingest on the same bytes gives the same verdicts as the
    # engine that wrote the snapshot.
    _same_report(reader.ingest(b, "fb"), writer.ingest(b, "fb"))
    assert list(reader.exact.items()) == list(writer.exact.items())


# tests/test_cdc_kernels.py's fan-out geometry.
FAN_GEO = dict(min_size=64, avg_bits=8, max_size=256, row_tile=8)


@pytest.fixture(scope="module")
def fan_out_reference():
    rng = np.random.RandomState(4)
    data = rng.randint(0, 256, 20000, dtype=np.uint8).tobytes()
    ref = JEngine(JConfig(fan_out=8, use_pallas=False, **FAN_GEO))
    return data, ref.fingerprint(data)


@pytest.mark.parametrize("fan", [dict(fan_out=8), dict(fan_out=2),
                                 dict(fan_out=4, devices=["cpu"] * 4),
                                 dict(devices=["cpu"] * 8)],
                         ids=["fan_out_8", "fan_out_2", "devices_4",
                              "devices_8_auto"])
def test_fan_out_matches_fan_out_1_and_reference(fan_out_reference, fan):
    data, ref = fan_out_reference
    fan = dict(fan)
    devices = fan.pop("devices", None)
    eng = DedupEngine(DedupConfig(**fan, **FAN_GEO), device="cpu",
                      devices=devices)
    assert len(eng.devices) == (fan.get("fan_out") or len(devices))
    ours = eng.fingerprint(data)
    one = DedupEngine(DedupConfig(fan_out=1, **FAN_GEO),
                      device="cpu").fingerprint(data)
    assert ours[0] == one[0] == ref[0]
    for i in (1, 2):
        assert np.array_equal(ours[i], one[i])
        assert np.array_equal(ours[i], ref[i])


def test_fan_out_must_divide_row_tile():
    with pytest.raises(ValueError, match="row_tile"):
        DedupEngine(DedupConfig(row_tile=8, fan_out=3), device="cpu")
    with pytest.raises(ValueError):
        DedupEngine(DedupConfig(fan_out=2), device="cpu",
                    devices=["cpu"] * 3)
    assert DedupEngine(DedupConfig(), device="cpu").devices == [
        torch.device("cpu")]


def test_fan_out_above_visible_cards_raises_on_cuda(monkeypatch):
    # A one-card host as torch sees it; the check comes before any
    # device memory is touched.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        DedupEngine(DedupConfig(fan_out=2), device="cuda")


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_fan_out_runs_are_contiguous_and_balanced(k):
    rng = np.random.RandomState(k)
    lens = rng.randint(1, 5000, 200).astype(np.int64)
    offsets = np.cumsum(lens) - lens
    runs = tengine._runs(offsets, lens, k)
    assert len(runs) == k and runs[0][0] == 0 and runs[-1][1] == 200
    assert all(a <= b for a, b in runs)
    assert all(b == a2 for (_, b), (a2, _) in zip(runs, runs[1:]))
    total = int(lens.sum())
    for a, b in runs:
        assert abs(int(lens[a:b].sum()) - total / k) <= lens.max()


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DedupEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DedupEngine(DedupConfig(**GEO), device="cuda:0")
