"""The port's ragged path: chunks read where they lie in a segment, by
offset and length (fastdfs_tpu_torch.ops sha1_ragged / sketch_ragged, the
ragged kernel wrappers on the CPU, DedupEngine.fingerprint and the
sidecar's DEDUP_VERIFY), against hashlib and the JAX package.

The edge segment puts every length of interest (0-8, 55-57, 63-65 and one
past the engine geometry's max_size) at every start offset mod 4, each
chunk followed by non-zero bytes, and ends with a chunk that touches the
segment's last byte.  Tolerance: exact equality (integer digests and
hashes).  JAX runs on the CPU (XLA survivor sketch, about a second of
compile per new shape); SHA-1 is held to hashlib, which the reference's
XLA sha1 equals by contract (it costs minutes of compile per shape).
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from fastdfs_tpu import sidecar as jsidecar
from fastdfs_tpu.dedup import DedupConfig as JConfig
from fastdfs_tpu.dedup import DedupEngine as JEngine
from fastdfs_tpu.dedup import engine as jengine
from fastdfs_tpu.ops import minhash as jm
from fastdfs_tpu_torch import sidecar as tsidecar
from fastdfs_tpu_torch.dedup import DedupConfig, DedupEngine
from fastdfs_tpu_torch.ops import bucket_lens, ragged_batches
from fastdfs_tpu_torch.ops import minhash as tm
from fastdfs_tpu_torch.ops import sha1 as tsha1
from fastdfs_tpu_torch.ops.cuda_minhash import (sketch_ragged_cuda,
                                                survivor_ragged_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_ragged_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


GEO = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
EDGE_LENS = list(range(9)) + [55, 56, 57, 63, 64, 65, 1400]  # 1400 > max_size
CASES = [(a, n) for a in range(4) for n in EDGE_LENS]
CASE_IDS = [f"off{a}-len{n}" for a, n in CASES]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _edge_segment():
    """(segment bytes, offsets, lengths): chunk c starts at an offset of
    CASES[c]'s residue mod 4 and is followed by 1-4 non-zero filler bytes,
    except the last chunk, which ends the segment."""
    rng = np.random.RandomState(41)
    seg = bytearray()
    offsets, lens = [], []
    for align, n in CASES + [(1, 37)]:
        seg += rng.randint(1, 256, 1 + (align - len(seg) - 1) % 4,
                           dtype=np.uint8).tobytes()
        assert len(seg) % 4 == align
        offsets.append(len(seg))
        lens.append(n)
        seg += rng.randint(1, 256, n, dtype=np.uint8).tobytes()
    return bytes(seg), np.array(offsets, np.int64), np.array(lens, np.int32)


def _tensors(seg, offsets, lens):
    return (torch.from_numpy(np.frombuffer(seg, np.uint8).copy()),
            torch.from_numpy(offsets), torch.from_numpy(lens))


def _padded(seg, offsets, lens):
    width = max(int(lens.max()), 1)
    rows = np.zeros((len(lens), width), np.uint8)
    for i, (o, n) in enumerate(zip(offsets, lens)):
        rows[i, :n] = np.frombuffer(seg, np.uint8, n, o)
    return rows


@functools.lru_cache(maxsize=None)
def _edge_results():
    seg, offsets, lens = _edge_segment()
    t = _tensors(seg, offsets, lens)
    digests = _u32(tsha1.sha1_ragged(*t, row_tile=8))
    sig, z = tm.sketch_ragged(*t, row_tile=8, with_z=True)
    rows = _padded(seg, offsets, lens)
    return (digests, _u32(sig), _u32(z),
            np.asarray(jm.minhash_batch(rows, lens)),
            np.asarray(jm.survivor_segmin(rows, lens)))


@pytest.mark.parametrize("case", range(len(CASES) + 1),
                         ids=CASE_IDS + ["last-chunk"])
def test_sha1_ragged_matches_hashlib(case):
    seg, offsets, lens = _edge_segment()
    got = tsha1.digest_bytes(_edge_results()[0][case])
    o, n = offsets[case], lens[case]
    assert got == hashlib.sha1(seg[o:o + n]).digest()


@pytest.mark.parametrize("case", range(len(CASES) + 1),
                         ids=CASE_IDS + ["last-chunk"])
def test_sketch_ragged_matches_reference(case):
    _, sig, z, sig_ref, z_ref = _edge_results()
    assert np.array_equal(z[case], z_ref[case])
    assert np.array_equal(sig[case], sig_ref[case])


def test_edge_segment_exercises_survivors_and_empty_chunks():
    _, sig, z, _, _ = _edge_results()
    nonempty = (z != tm.EMPTY).any(axis=1)
    assert nonempty.any() and not nonempty.all()
    assert (sig[~nonempty] == tm.EMPTY).all()


def test_wrappers_take_the_twins_on_cpu_into_wider_columns():
    seg, offsets, lens = _edge_segment()
    t = _tensors(seg, offsets, lens)
    digests, sig = _edge_results()[:2]
    order = torch.from_numpy(np.argsort(-lens, kind="stable").astype(np.int32))
    out = torch.full((len(lens), 5 + 64), -1, dtype=torch.int32)
    before = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
    sha1_ragged_cuda(*t, order, out[:, :5], row_tile=16)
    sketch_ragged_cuda(*t, tm.perm_words(64, "cpu"), order, out[:, 5:],
                       row_tile=16)
    assert (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches) == before
    packed = out.numpy().view(np.uint32)
    assert np.array_equal(packed[:, :5], digests)
    assert np.array_equal(packed[:, 5:], sig)
    assert np.array_equal(_u32(sha1_ragged_cuda(*t)), digests)
    assert np.array_equal(_u32(sketch_ragged_cuda(*t)), sig)


def test_survivor_wrapper_and_signature_tiles_match_reference():
    seg, offsets, lens = _edge_segment()
    t = _tensors(seg, offsets, lens)
    sig_ref, z_ref = _edge_results()[3:]
    before = survivor_ragged_cuda.launches
    got = _u32(survivor_ragged_cuda(*t, row_tile=16))
    assert survivor_ragged_cuda.launches == before
    assert np.array_equal(got, z_ref)
    z = torch.from_numpy(z_ref.view(np.int32).copy()).view(torch.uint32)
    for row_tile in (1, 7, 1000):
        assert np.array_equal(_u32(tm.signature_tiles(z, 64, None, row_tile)),
                              sig_ref)


@pytest.mark.parametrize("case", ["seg_dtype", "seg_ndim", "offsets_dtype",
                                  "lens_dtype", "lens_shape", "order_dtype",
                                  "out_shape", "out_dtype"])
def test_ragged_wrappers_reject_bad_inputs(case):
    seg = torch.zeros(64, dtype=torch.uint8)
    offsets = torch.zeros(3, dtype=torch.int64)
    lens = torch.ones(3, dtype=torch.int32)
    order, out = None, None
    if case == "seg_dtype":
        seg = seg.to(torch.int32)
    elif case == "seg_ndim":
        seg = seg.reshape(8, 8)
    elif case == "offsets_dtype":
        offsets = offsets.to(torch.int32)
    elif case == "lens_dtype":
        lens = lens.to(torch.int64)
    elif case == "lens_shape":
        lens = lens[:2]
    elif case == "order_dtype":
        order = torch.arange(3)
    elif case == "out_shape":
        out = torch.zeros((3, 4), dtype=torch.int32)
    else:
        out = torch.zeros((3, 5), dtype=torch.int64)
    with pytest.raises(ValueError):
        sha1_ragged_cuda(seg, offsets, lens, order, out)
    with pytest.raises(ValueError):
        sketch_ragged_cuda(seg, offsets, lens, None, order,
                           None if out is None else out[:, :1])


@pytest.mark.parametrize("geo", [(64, 1024), (2048, 65536), (1, 8)])
def test_bucket_lens_matches_reference_rule(geo):
    n = np.arange(0, 140_000, 37)
    want = [jengine._bucket_len(int(x), *geo) for x in n]
    assert bucket_lens(n, *geo).tolist() == want


def test_ragged_batches_pad_with_zeros_and_cover_every_chunk():
    seg, offsets, lens = _edge_segment()
    t = _tensors(seg, offsets, lens)
    seen = []
    for rows, batch, ln in ragged_batches(*t, row_tile=5):
        assert batch.shape[0] <= 5 and batch.dtype == torch.uint8
        for r, i in enumerate(rows.tolist()):
            n = int(ln[r])
            o = int(offsets[i])
            assert batch[r, :n].numpy().tobytes() == seg[o:o + n]
            assert not batch[r, n:].any()
        seen += rows.tolist()
    assert sorted(seen) == list(range(len(lens)))


def test_perm_words_round_trip_to_plain_constants():
    (lo, hi), b = tm.perms_from_words(tm.perm_words(64, "cpu"))
    (lo2, hi2), b2 = tm.perm_tensors(64, "cpu")
    assert torch.equal(lo, lo2) and torch.equal(hi, hi2) and torch.equal(b, b2)


# -- the engine on unaligned caller cuts -----------------------------------

def _rand(rng, n):
    return rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


# Chunks of every start residue mod 4, lengths 1-8 and 55-65 among them,
# one past max_size (1400) and a last chunk that ends the data.
CUT_CASES = {
    "edges": [1, 3, 6, 10, 15, 21, 28, 36, 91, 147, 204, 267, 331, 396,
              1796, 1900, 2000],
    "one_byte_chunks": list(range(1, 40)) + [600, 2000],
    "past_max_size": [57, 1457, 2000],
}


@pytest.mark.parametrize("name", list(CUT_CASES))
def test_engine_unaligned_caller_cuts_match_reference(name):
    data = _rand(np.random.RandomState(43), 2000)
    cuts = CUT_CASES[name]
    ours = DedupEngine(DedupConfig(**GEO), device="cpu")
    got = ours.fingerprint(data, cuts=cuts)
    want = JEngine(JConfig(**GEO)).fingerprint(data, cuts=cuts)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    raw = got[1].astype(">u4").tobytes()
    for i, (off, ln) in enumerate(got[0]):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(data[off:off + ln]).digest()


def test_engine_whole_segment_as_one_chunk():
    data = _rand(np.random.RandomState(44), 1400)
    spans, digests, sigs = DedupEngine(DedupConfig(**GEO),
                                       device="cpu").fingerprint(data, cuts=[1400])
    want = JEngine(JConfig(**GEO)).fingerprint(data, cuts=[1400])
    assert spans == [(0, 1400)]
    assert digests.astype(">u4").tobytes() == hashlib.sha1(data).digest()
    assert np.array_equal(sigs, want[2])


def test_engine_staging_reuse_after_a_larger_segment():
    # The staging buffer keeps a larger segment's bytes past a smaller
    # one's end: results must not see them.
    rng = np.random.RandomState(45)
    big, small = _rand(rng, 6000), _rand(rng, 700)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    eng.fingerprint(big)
    got = eng.fingerprint(small, cuts=[3, 700])
    fresh = DedupEngine(DedupConfig(**GEO), device="cpu").fingerprint(
        small, cuts=[3, 700])
    assert got[0] == fresh[0]
    assert np.array_equal(got[1], fresh[1])
    assert np.array_equal(got[2], fresh[2])
    assert got[1][0].astype(">u4").tobytes() == hashlib.sha1(small[:3]).digest()


@pytest.mark.parametrize("cuts", [[5, 3, 10], [10, 2001], [-1, 10]],
                         ids=["decreasing", "past_data", "negative"])
def test_engine_rejects_bad_cuts(cuts):
    with pytest.raises(ValueError):
        DedupEngine(DedupConfig(**GEO), device="cpu").fingerprint(
            bytes(2000), cuts=cuts)


@pytest.mark.parametrize("sketch", [dict(num_perms=32), dict(shingle=4)],
                         ids=["32_perms", "shingle_4"])
def test_engine_other_sketch_settings_match_reference(sketch):
    data = _rand(np.random.RandomState(46), 3000)
    geo = dict(GEO, **sketch)
    cuts = [7, 700, 1800, 3000]
    ours = DedupEngine(DedupConfig(**geo), device="cpu").fingerprint(data, cuts)
    ref = JEngine(JConfig(**geo)).fingerprint(data, cuts)
    assert ours[2].shape == (4, geo.get("num_perms", 64))
    assert np.array_equal(ours[1], ref[1])
    assert np.array_equal(ours[2], ref[2])


# -- DEDUP_VERIFY over the payloads as they arrived --------------------------

def _verify_body(chunks, expected, extra=b""):
    head = np.zeros(len(chunks), dtype=[("l", ">i8"), ("d", "S20")])
    head["l"] = [len(c) for c in chunks]
    head["d"] = expected
    return (len(chunks).to_bytes(8, "big", signed=True) + head.tobytes()
            + b"".join(chunks) + extra)


def _verify_bodies():
    rng = np.random.RandomState(47)
    chunks = [_rand(rng, n) for n in (0, 1, 3, 5, 55, 64, 65, 1400, 7)]
    good = [hashlib.sha1(c).digest() for c in chunks]
    bad = list(good)
    bad[3] = bytes(20)
    bad[7] = good[6]
    neg = bytearray(_verify_body(chunks[:2], good[:2]))
    neg[8:16] = (-1).to_bytes(8, "big", signed=True)
    return {
        "all_match": _verify_body(chunks, good),
        "two_mismatch": _verify_body(chunks, bad),
        "empty": (0).to_bytes(8, "big"),
        "empty_with_payload": (0).to_bytes(8, "big") + b"xy",
        "sum_mismatch": _verify_body(chunks, good, extra=b"z"),
        "negative_length": bytes(neg),
        "short_header": (3).to_bytes(8, "big") + bytes(20),
        "short": b"\x00\x01",
    }


@pytest.mark.parametrize("name", list(_verify_bodies()))
def test_verify_matches_reference(tmp_path, name):
    body = _verify_bodies()[name]
    ours = tsidecar.DedupSidecar(str(tmp_path / "t.sock"), None,
                                 DedupConfig(**GEO), device="cpu")
    ref = jsidecar.DedupSidecar(str(tmp_path / "j.sock"), None, JConfig(**GEO))
    ref._batch_sha1 = lambda chunks: [hashlib.sha1(c).digest() for c in chunks]
    assert ours._verify(body) == ref._verify(body)


def test_verify_answers_status_5_when_the_kernel_fails(tmp_path, monkeypatch):
    ours = tsidecar.DedupSidecar(str(tmp_path / "t.sock"), None,
                                 DedupConfig(**GEO), device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA kernel sha1_ragged failed to launch")

    monkeypatch.setattr(tsidecar, "sha1_ragged_cuda", broken)
    assert ours._verify(_verify_bodies()["all_match"]) == (5, b"")
