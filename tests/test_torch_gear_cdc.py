"""The port's gear CDC (fastdfs_tpu_torch.ops.gear_cdc): host half and
torch device half (run on the CPU here) against the JAX package's serial
referees and the checked-in cut golden.

Tolerance: exact equality (cut offsets and integer hashes).
"""

import hashlib
import json
import os
import threading

import numpy as np
import pytest
import torch

from fastdfs_tpu.ops import gear_cdc as jg
from fastdfs_tpu_torch.ops import gear_cdc as tg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "goldens", "cdc_cuts.json")

with open(GOLDEN_PATH) as _fh:
    _CASES = json.load(_fh)["cases"]
_IDS = [c["name"] for c in _CASES]


def _corpus(kind: str, seed: int, length: int) -> bytes:
    """The golden's corpus recipe (its 'corpus' field)."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, 256, length, dtype=np.uint8).tobytes()
    if kind == "lowentropy":
        return rng.randint(0, 16, length, dtype=np.uint8).tobytes()
    if kind == "repetitive":
        tile = rng.randint(0, 256, 512, dtype=np.uint8).tobytes()
        return (tile * (length // len(tile) + 1))[:length]
    raise ValueError(kind)


def _geo(case):
    return case["min_size"], case["avg_bits"], case["max_size"]


def test_constants_match_reference():
    assert np.array_equal(tg.GEAR_TABLE, jg.GEAR_TABLE)
    assert tg.GEAR_TABLE.dtype == jg.GEAR_TABLE.dtype
    assert tg.CDC_SPEC_VERSION == jg.CDC_SPEC_VERSION
    assert tg.CDC_POLICY_DEFAULT == jg.CDC_POLICY_DEFAULT
    assert tg.CDC_POLICY_SKIPMIN == jg.CDC_POLICY_SKIPMIN
    assert tg.WINDOW == jg.WINDOW
    assert (tg.DEFAULT_MIN_SIZE, tg.DEFAULT_AVG_BITS, tg.DEFAULT_MAX_SIZE) == \
        (jg.DEFAULT_MIN_SIZE, jg.DEFAULT_AVG_BITS, jg.DEFAULT_MAX_SIZE)


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_golden_gear_hash_stream_device_half(case):
    data = _corpus(case["kind"], case["seed"], case["length"])
    h = tg.gear_hashes(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    assert hashlib.sha1(h.numpy().astype("<u4").tobytes()).hexdigest() == \
        case["gear_sha1"]


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_golden_cuts_host_half(case):
    data = _corpus(case["kind"], case["seed"], case["length"])
    assert tg.chunk_stream_np(data, *_geo(case)) == case["cuts_default"]
    assert tg.chunk_stream_np(data, *_geo(case),
                              cdc_policy=tg.CDC_POLICY_SKIPMIN) == \
        case["cuts_skipmin"]


@pytest.mark.parametrize("policy", [1, 2], ids=["default", "skipmin"])
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_golden_cuts_device_half(case, policy):
    data = _corpus(case["kind"], case["seed"], case["length"])
    want = case["cuts_default"] if policy == 1 else case["cuts_skipmin"]
    assert tg.chunk_stream(data, *_geo(case), cdc_policy=policy,
                           device="cpu") == want


def _adversarial():
    rng = np.random.RandomState(99)
    return [
        ("empty", b""),
        ("one", b"\x42"),
        ("below_min", rng.randint(0, 256, 63, dtype=np.uint8).tobytes()),
        ("all_zero", bytes(5000)),
        ("all_identical", b"\xab" * 5000),
        ("pow2_minus1", rng.randint(0, 256, 4095, dtype=np.uint8).tobytes()),
        ("pow2", rng.randint(0, 256, 4096, dtype=np.uint8).tobytes()),
        ("pow2_plus1", rng.randint(0, 256, 4097, dtype=np.uint8).tobytes()),
    ]


@pytest.mark.parametrize("name,data", _adversarial(),
                         ids=[n for n, _ in _adversarial()])
def test_adversarial_buffers_match_serial_referees(name, data):
    geo = (64, 8, 1024)
    want = jg.chunk_stream_ref(data, *geo)
    want_skip = jg.chunk_stream_skipmin_ref(data, *geo)
    assert tg.chunk_stream_ref(data, *geo) == want
    assert tg.chunk_stream_skipmin_ref(data, *geo) == want_skip
    assert tg.chunk_stream_np(data, *geo) == want
    assert tg.chunk_stream(data, *geo, device="cpu") == want
    assert tg.chunk_stream(data, *geo, cdc_policy=2, device="cpu") == want_skip


@pytest.mark.parametrize("policy", [1, 2], ids=["default", "skipmin"])
def test_candidate_overflow_recovers_from_dense_mask(policy):
    # k=4 candidate slots cannot hold a 20 KB stream's candidates: the
    # dense-mask recovery must give the exact cuts anyway.
    data = np.random.RandomState(7).randint(0, 256, 20000,
                                            dtype=np.uint8).tobytes()
    geo = (64, 8, 1024)
    want = (jg.chunk_stream_ref(data, *geo) if policy == 1
            else jg.chunk_stream_skipmin_ref(data, *geo))
    assert tg.chunk_stream(data, *geo, cdc_policy=policy, _k_override=4,
                           device="cpu") == want


def test_gear_candidates_fixed_size_padded_with_length():
    data = np.random.RandomState(8).randint(0, 256, 4096, dtype=np.uint8)
    dev = torch.from_numpy(data)
    dense = np.flatnonzero((jg.gear_hashes_np(data) & 0xFF) == 0)
    dense = dense[dense < 3000]
    k = len(dense) + 5
    got = tg.gear_candidates(dev, 3000, 8, k).numpy()
    assert np.array_equal(got[:len(dense)], dense)
    assert (got[len(dense):k] == 4096).all()
    out = tg.gear_candidates(dev, 3000, 8, 3).numpy()
    assert np.array_equal(out[:3], dense[:3])
    assert out[3] == len(dense)


def test_gear_hashes_match_serial_reference():
    data = np.random.RandomState(10).randint(0, 256, 1500, dtype=np.uint8)
    want = jg.gear_hashes_ref(data)
    assert np.array_equal(tg.gear_hashes(torch.from_numpy(data)).numpy(), want)
    assert np.array_equal(tg.gear_hashes_ref(data), want)
    assert np.array_equal(tg.gear_hashes_np(data), want)


def test_select_cuts_match_reference():
    rng = np.random.RandomState(12)
    cand = np.sort(rng.choice(50000, 400, replace=False))
    assert tg.select_cuts(cand, 50000, 64, 1024) == \
        jg.select_cuts(cand, 50000, 64, 1024)
    with pytest.raises(ValueError):
        tg.select_cuts(cand, 50000, 16, 1024)


def test_unknown_policy_rejected():
    with pytest.raises(ValueError):
        tg.chunk_stream(b"abc", cdc_policy=3, device="cpu")
    with pytest.raises(ValueError):
        tg.chunk_stream_np(b"abc", cdc_policy=3)


def test_staging_buffers_are_thread_local_and_reused():
    a = tg.staging_buffer(1024, slot=5)
    assert tg.staging_buffer(1024, slot=5) is a
    other = []
    t = threading.Thread(target=lambda: other.append(tg.staging_buffer(1024, slot=5)))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert other[0] is not a
    data = np.random.RandomState(13).randint(0, 256, 300_000,
                                             dtype=np.uint8).tobytes()
    tg.chunk_stream_np(data)
    before = tg.staging_buffer_stats()
    tg.chunk_stream_np(data + data)
    assert tg.staging_buffer_stats() == before
