"""The port's client fingerprint (fastdfs_tpu_torch.client.fingerprint)
against the JAX package's ``fingerprint_buffer`` and hashlib.

``device="cpu"`` is the reference's own route on a host without an
accelerator (NumPy CDC plus hashlib).  The card's route (one upload with
slack, device CDC, one ragged SHA-1 launch) is composed by
``_fingerprint_device`` and ``_digests_device``; here they run on the CPU,
where the SHA-1 wrapper takes its plain twin, so that composition is
tested too.  Tolerance: exact equality (cut lengths and raw digests).
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from fastdfs_tpu.client import fingerprint as jfp
from fastdfs_tpu_torch import bench_configs
from fastdfs_tpu_torch.client import ChunkFingerprint, fingerprint_buffer
from fastdfs_tpu_torch.client import fingerprint as tfp
from fastdfs_tpu_torch.ops import SEGMENT_SLACK, gear_cdc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


DEFAULT_GEO = (gear_cdc.DEFAULT_MIN_SIZE, gear_cdc.DEFAULT_AVG_BITS,
               gear_cdc.DEFAULT_MAX_SIZE)
SMALL_GEO = (64, 8, 1024)
POLICIES = [gear_cdc.CDC_POLICY_DEFAULT, gear_cdc.CDC_POLICY_SKIPMIN]


def _payload(kind: str, geo) -> bytes:
    min_size, _, max_size = geo
    rng = np.random.RandomState(len(kind) * 7919 + min_size)
    size = {"empty": 0, "one": 1, "min-1": min_size - 1, "max": max_size,
            "2^18": 1 << 18, "300k": 300_000, "repetitive": 200_000}[kind]
    if kind == "repetitive":
        tile = rng.randint(0, 256, 512, dtype=np.uint8).tobytes()
        return (tile * (size // len(tile) + 1))[:size]
    return rng.randint(0, 256, size, dtype=np.uint8).tobytes()


def _pairs(fps):
    return [(f.length, f.digest) for f in fps]


KINDS = ["empty", "one", "min-1", "max", "2^18", "300k", "repetitive"]


@pytest.mark.parametrize("policy", POLICIES, ids=["default", "skipmin"])
@pytest.mark.parametrize("geo", [DEFAULT_GEO, SMALL_GEO],
                         ids=["geo-default", "geo-small"])
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_route_matches_reference(kind, geo, policy):
    data = _payload(kind, geo)
    got = fingerprint_buffer(data, *geo, cdc_policy=policy, device="cpu")
    want = jfp.fingerprint_buffer(data, *geo, cdc_policy=policy)
    assert all(isinstance(f, ChunkFingerprint) for f in got)
    assert _pairs(got) == _pairs(want)
    assert sum(f.length for f in got) == len(data)


# The card's route at the small geometry (the plain SHA-1 twin is slow on
# long chunks): lengths below, at and above a power of two, where the
# device pass's buffer has no room of its own past the payload.  Then
# config 6's first 256 KB blob and its edited copy at the default
# geometry and policy, the client's calls in that config.
DEVICE_SIZES = [1, 63, 4096, 4097, 8192, 20_000]
DEVICE_CASES = (
    [(n, SMALL_GEO, p) for p in POLICIES for n in DEVICE_SIZES]
    + [(blob, DEFAULT_GEO, gear_cdc.CDC_POLICY_DEFAULT)
       for blob in ("config6", "config6-edited")])


def _device_payload(n) -> bytes:
    if isinstance(n, str):
        corpus, edited = bench_configs._config6_corpus(0)
        return (corpus if n == "config6" else edited)[0]
    return np.random.RandomState(n).randint(0, 256, n,
                                            dtype=np.uint8).tobytes()


@pytest.mark.parametrize(
    "n,geo,policy", DEVICE_CASES,
    ids=[f"{n}-{'default' if p == POLICIES[0] else 'skipmin'}"
         for n, _, p in DEVICE_CASES])
def test_device_route_matches_reference(n, geo, policy):
    data = _device_payload(n)
    cuts, digests = tfp._fingerprint_device(data, *geo, policy,
                                            torch.device("cpu"))
    got = list(zip(np.diff([0] + cuts).tolist(), digests))
    assert got == _pairs(jfp.fingerprint_buffer(data, *geo,
                                                cdc_policy=policy))


def test_upload_leaves_slack_past_a_power_of_two():
    data = bytes(range(256)) * 16                        # 4096 = 2^12
    host, seg = gear_cdc.upload_padded(data, "cpu", slack=SEGMENT_SLACK)
    assert seg.shape[0] >= len(data) + SEGMENT_SLACK
    assert bytes(seg[:len(data)].numpy()) == data
    assert not seg[len(data):].any()
    assert gear_cdc.device_cuts(host, seg, len(data), *SMALL_GEO) == \
        gear_cdc.chunk_stream_np(data, *SMALL_GEO)


def _edge_buffer():
    """Chunks of edge lengths (0, 1, 55-57, 63-65, 119, 3) back to back,
    then non-zero bytes past the last cut."""
    rng = np.random.RandomState(17)
    lens = [1, 55, 56, 57, 0, 63, 64, 65, 119, 3]
    payload = rng.randint(1, 256, sum(lens), dtype=np.uint8).tobytes()
    tail = rng.randint(1, 256, SEGMENT_SLACK + 5, dtype=np.uint8).tobytes()
    return payload, payload + tail, np.cumsum(lens).tolist()


@pytest.mark.parametrize("cut_kind", ["edge", "cdc"])
def test_digests_device_match_hashlib_with_nonzero_tail(cut_kind):
    if cut_kind == "edge":
        payload, buf, cuts = _edge_buffer()
    else:
        rng = np.random.RandomState(23)
        payload = rng.randint(0, 256, 12_345, dtype=np.uint8).tobytes()
        buf = payload + rng.randint(1, 256, 2 * SEGMENT_SLACK,
                                    dtype=np.uint8).tobytes()
        cuts = gear_cdc.chunk_stream_np(payload, *SMALL_GEO)
    seg = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    got = tfp._digests_device(seg, cuts)
    want = [hashlib.sha1(payload[a:b]).digest()
            for a, b in zip([0] + cuts[:-1], cuts)]
    assert got == want


def test_digests_device_checks_its_input():
    payload, buf, cuts = _edge_buffer()
    seg = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    assert tfp._digests_device(seg, []) == []
    with pytest.raises(ValueError):        # less than the slack past the end
        tfp._digests_device(seg[:len(payload) + SEGMENT_SLACK - 1], cuts)
    with pytest.raises(ValueError):        # decreasing cuts
        tfp._digests_device(seg, [10, 5])


def test_device_route_staging_is_per_thread():
    # Every thread stages a payload of the same staging size, then waits
    # until all have staged before reading its own back: a shared buffer
    # would hold the last writer's bytes.
    rng = np.random.RandomState(29)
    payloads = [rng.randint(0, 256, n, dtype=np.uint8).tobytes()
                for n in (3000, 3001, 2900, 4000)]
    staged = threading.Barrier(len(payloads), timeout=60)
    results = {}

    def work(i):
        host, seg = gear_cdc.upload_padded(payloads[i], "cpu",
                                           slack=SEGMENT_SLACK)
        staged.wait()
        results[i] = (bytes(seg[:len(payloads[i])].numpy()),
                      gear_cdc.device_cuts(host, seg, len(payloads[i]),
                                           *SMALL_GEO))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i, p in enumerate(payloads):
        assert results[i] == (p, gear_cdc.chunk_stream_np(p, *SMALL_GEO))


def test_unknown_policy_rejected_on_both_routes():
    with pytest.raises(ValueError):
        fingerprint_buffer(b"abc", cdc_policy=3, device="cpu")
    with pytest.raises(ValueError):
        tfp._fingerprint_device(b"abc", *SMALL_GEO, 3, torch.device("cpu"))


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fingerprint_buffer(b"x" * 5000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fingerprint_buffer(b"")
