"""The wrappers of the port's gear CDC and index-query kernels
(``ops.cuda_gear``, ``ops.cuda_index``), run on the CPU, where each takes
its plain twin, against the JAX package: ``gear_candidates`` and
``gear_hashes`` (XLA on the CPU), and the ingest step's stage-4 formula
(``eq.mean(axis=2, dtype=float32)``, max with ``initial=0.0``).  Also the
candidate count, the count-based overflow recovery of ``device_cuts``,
the 31-byte halo at block seams, the wrappers' argument checks and the
kernel sources' C signatures.

The CUDA kernels themselves are held to these twins on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Inputs are seeded
with numpy at a few KiB.  Tolerance: exact equality (integer positions,
counts and masks; similarities are the same float32 on both sides).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdfs_tpu.ops import gear_cdc as jg
from fastdfs_tpu.ops.minhash import estimate_jaccard as jestimate_jaccard
from fastdfs_tpu_torch.ops import _build, mean_of_count
from fastdfs_tpu_torch.ops import gear_cdc as tg
from fastdfs_tpu_torch.ops.cuda_gear import (HALO, RUN, TILE,
                                             block_candidates_cuda,
                                             gear_candidates_cuda)
from fastdfs_tpu_torch.ops.cuda_index import index_best_cuda
from fastdfs_tpu_torch.ops.minhash import estimate_jaccard
from fastdfs_tpu_torch.parallel import ingest_step
from tests.torch_native import (dense_pair, plant_candidate, plant_wide,
                                wide_seam_plants)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_candidates(data: np.ndarray, n: int, avg_bits: int) -> np.ndarray:
    h = np.asarray(jg.gear_hashes(jnp.asarray(data)))
    return np.flatnonzero((h[:n] & ((1 << avg_bits) - 1)) == 0)


# -- compacted form ----------------------------------------------------------

@pytest.mark.parametrize("size,n,avg_bits,k", [
    (4096, 4096, 8, 64),          # k past the count: padded with 4096
    (4096, 3001, 6, 16),          # n below the buffer, k short of the count
    (8192, 8192, 5, 1000),        # the reference's lane-folded hash
    (8192, 100, 0, 128),          # avg_bits 0: every position below n
])
def test_gear_candidates_equal_the_reference(size, n, avg_bits, k):
    data = np.random.RandomState(size + n).randint(0, 256, size,
                                                   dtype=np.uint8)
    want = np.asarray(jg.gear_candidates(jnp.asarray(data), n, avg_bits, k))
    out = gear_candidates_cuda(torch.from_numpy(data), n, avg_bits, k)
    assert out.dtype == torch.int64 and out.shape == (k + 1,)
    assert np.array_equal(out[:k].numpy(), want)
    assert int(out[k]) == len(_ref_candidates(data, n, avg_bits))


def test_count_counts_past_k_and_only_below_n():
    data = np.random.RandomState(5).randint(0, 256, 4096, dtype=np.uint8)
    dense = _ref_candidates(data, 4096, 4)
    n = int(dense[len(dense) // 2])          # a candidate at n: not counted
    out = gear_candidates_cuda(torch.from_numpy(data), n, 4, 3).numpy()
    assert out[3] == len(dense) // 2 > 3
    assert np.array_equal(out[:3], dense[:3])
    out = gear_candidates_cuda(torch.from_numpy(data), 0, 4, 3).numpy()
    assert np.array_equal(out, [4096] * 3 + [0])


def test_candidates_at_tile_seams_and_the_first_window():
    # Plant candidates on both sides of the kernel's thread-run and tile
    # seams (its exported geometry) and in the first window.
    bits = 13
    data = np.random.RandomState(7).randint(0, 256, 4 * TILE, dtype=np.uint8)
    planted = [p for p in range(1, 32, 2)]
    for seam in (RUN, 2 * RUN, TILE - RUN, TILE, 2 * TILE, 3 * TILE):
        planted += [seam - 3, seam - 1, seam + 1, seam + 3]
    for p in planted:
        plant_candidate(data, p, bits)
    ref = _ref_candidates(data, len(data), bits)
    assert set(planted) <= set(ref.tolist())
    out = gear_candidates_cuda(torch.from_numpy(data), len(data), bits,
                               len(ref)).numpy()
    assert out[-1] == len(ref) and np.array_equal(out[:-1], ref)


@pytest.mark.parametrize("avg_bits", [17, 18, 32])
def test_wide_avg_bits_at_the_seams_in_both_forms(avg_bits):
    # Past 17 bits a window reaches 32 bytes before a thread's run: plant
    # candidates whose windows cross the run and tile seams, and at the
    # second row's start, whose window lies in the halo.
    size = 2 * TILE + 77
    data = np.random.RandomState(avg_bits).randint(0, 256, size,
                                                   dtype=np.uint8)
    planted = wide_seam_plants(size, avg_bits)
    for p in planted:
        plant_wide(data, p, avg_bits)
    ref = _ref_candidates(data, size, avg_bits)
    assert set(planted) <= set(ref.tolist())
    out = gear_candidates_cuda(torch.from_numpy(data), size, avg_bits,
                               len(ref) + 2).numpy()
    assert out[-1] == len(ref) and np.array_equal(out[:len(ref)], ref)
    assert (out[len(ref):-1] == size).all()
    rows = torch.from_numpy(data[:2 * TILE]).view(2, TILE)
    halo = torch.cat([torch.zeros((1, HALO), dtype=torch.int64),
                      tg.gear_values(rows[:1, -HALO:])])
    got = block_candidates_cuda(rows, halo, avg_bits).reshape(-1).numpy()
    assert np.array_equal(np.flatnonzero(got), ref[ref < 2 * TILE])


def test_kernel_geometry_matches_the_wrapper():
    # The wrapper's tile and run (the tests' seams, the scratch it
    # allocates) are the constants the kernel source is built with.
    text = (_build.CSRC / "gear_cdc.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = ([^;]+);", text)
        assert m is not None, name
        return m.group(1).strip()

    threads, run = int(const("kThreads")), int(const("kRun"))
    assert const("kTile") == "kThreads * kRun"
    assert int(const("kHalo")) == HALO
    assert (run, threads * run) == (RUN, TILE)
    assert TILE % RUN == 0 and RUN % 16 == 0


# -- overflow recovery --------------------------------------------------------

@pytest.mark.parametrize("policy", [tg.CDC_POLICY_DEFAULT,
                                    tg.CDC_POLICY_SKIPMIN])
def test_overflow_recovery_runs_again_with_the_count(monkeypatch, policy):
    geo = (64, 6, 1024)
    data = np.random.RandomState(11).randint(0, 256, 20000,
                                             dtype=np.uint8).tobytes()
    calls = []
    real = tg.gear_candidates_cuda

    def recording(buf, n, avg_bits, k):
        calls.append(k)
        return real(buf, n, avg_bits, k)

    monkeypatch.setattr(tg, "gear_candidates_cuda", recording)
    got = tg.chunk_stream(data, *geo, cdc_policy=policy, _k_override=4,
                          device="cpu")
    want = (jg.chunk_stream_ref(data, *geo) if policy == tg.CDC_POLICY_DEFAULT
            else jg.chunk_stream_skipmin_ref(data, *geo))
    assert got == want
    n_cand = len(_ref_candidates(np.frombuffer(data, np.uint8), len(data), 6))
    assert calls == [4, n_cand]                # the count sized the rerun


def test_dense_run_overflows_the_default_k_and_recovers(monkeypatch):
    bits = 13
    x, y = dense_pair(bits)
    buf = np.random.RandomState(12).randint(0, 256, 1 << 16, dtype=np.uint8)
    buf[20000:20000 + 4096] = np.tile(np.array([x, y], np.uint8), 2048)
    data = buf.tobytes()
    calls = []
    real = tg.gear_candidates_cuda
    monkeypatch.setattr(tg, "gear_candidates_cuda",
                        lambda *a: calls.append(a[3]) or real(*a))
    assert tg.chunk_stream(data, device="cpu") == jg.chunk_stream_ref(data)
    assert calls[0] == 256 and calls[1] > 2000   # the run holds ~2040


# -- dense form with a halo ---------------------------------------------------

@pytest.mark.parametrize("sp,avg_bits", [(2, 13), (4, 8)])
def test_block_candidates_with_halos_equal_the_whole_streams(sp, avg_bits):
    block = 4096
    rng = np.random.RandomState(sp)
    streams = rng.randint(0, 256, (2, sp * block), dtype=np.uint8)
    planted = [1, 5, 29, 31]
    for s in range(1, sp):
        planted += [s * block + d for d in (-3, -1, 1, 3, 29, 31)]
    for stream in streams:
        for p in planted:
            plant_candidate(stream, p, avg_bits)
    want = np.stack([np.asarray(jg.candidate_mask(
        jg.gear_hashes(jnp.asarray(s)), avg_bits)) for s in streams])
    assert want[:, planted].all()
    t = torch.from_numpy(streams).view(2, sp, block)
    got = []
    for s in range(sp):
        rows = t[:, s, :]                       # row stride sp * block
        halo = (tg.gear_values(t[:, s - 1, -HALO:]) if s else
                torch.zeros((2, HALO), dtype=torch.int64))
        got.append(block_candidates_cuda(rows, halo, avg_bits))
    assert np.array_equal(torch.cat(got, dim=1).numpy(), want)


def test_block_candidates_equal_the_plain_twin_on_gear_values():
    rng = np.random.RandomState(3)
    rows = torch.from_numpy(rng.randint(0, 256, (3, 700), dtype=np.uint8))
    halo = torch.from_numpy(rng.randint(0, 2**32, (3, HALO), dtype=np.int64))
    assert torch.equal(block_candidates_cuda(rows, halo, 4),
                       tg.block_candidates(tg.gear_values(rows), halo, 4))
    assert ingest_step.block_candidates is tg.block_candidates


# -- index query ---------------------------------------------------------------

@jax.jit
def _jbest(sigs, index):
    """The reference step's stage 4 (fastdfs_tpu/parallel/ingest_step.py:
    130-132) on one shard."""
    eq = sigs[:, None, :] == index[None, :, :]
    scores = eq.mean(axis=2, dtype=jnp.float32)
    return jnp.max(scores, axis=1, initial=0.0)


@pytest.mark.parametrize("n,m,p", [
    (70, 0, 64),       # empty shard: 0.0
    (70, 130, 64),     # N and M not multiples of the kernel's 64
    (129, 33, 16),
    (65, 40, 33),      # P not a power of two
    (33, 17, 48),
])
def test_index_best_equals_the_reference_formula(n, m, p):
    rng = np.random.RandomState(n * m + p)
    index = rng.randint(0, 3, (m, p)).astype(np.uint32)
    sigs = rng.randint(0, 3, (n, p)).astype(np.uint32)
    if m:
        sigs[:5] = index[rng.randint(0, m, 5)]      # exact matches: 1.0
        sigs[5:7] = index[0]                        # ties
    want = np.asarray(_jbest(jnp.asarray(sigs), jnp.asarray(index)))
    got = index_best_cuda(torch.from_numpy(sigs.view(np.int32)),
                          torch.from_numpy(index.view(np.int32)))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    if m:
        assert (got[:7] == 1.0).all()
    else:
        assert (got == 0.0).all()


def test_mean_of_count_rounds_as_the_reference():
    # XLA's float32 mean multiplies by the float32 reciprocal; a true
    # division differs in the last bit for some counts.
    for p in (7, 33, 48, 64, 100):
        eq = np.tri(p + 1, p, -1, dtype=bool)        # k ones in row k
        want = np.asarray(jnp.asarray(eq).mean(axis=1, dtype=jnp.float32))
        got = mean_of_count(torch.arange(p + 1), p).numpy()
        assert np.array_equal(got, want), p
    rng = np.random.RandomState(1)
    a = rng.randint(0, 3, (200, 48)).astype(np.uint32)
    b = rng.randint(0, 3, (200, 48)).astype(np.uint32)
    assert np.array_equal(
        estimate_jaccard(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jestimate_jaccard(jnp.asarray(a), jnp.asarray(b))))


# -- argument checks and the build --------------------------------------------

@pytest.mark.parametrize("case", ["dtype", "ndim", "strided", "n", "k",
                                  "bits"])
def test_gear_candidates_cuda_rejects(case):
    buf = torch.zeros(4096, dtype=torch.uint8)
    args = {"dtype": (buf.to(torch.int32), 10, 13, 4),
            "ndim": (buf.view(64, 64), 10, 13, 4),
            "strided": (buf[::2], 10, 13, 4),
            "n": (buf, 4097, 13, 4),
            "k": (buf, 10, 13, -1),
            "bits": (buf, 10, 33, 4)}[case]
    with pytest.raises(ValueError):
        gear_candidates_cuda(*args)


@pytest.mark.parametrize("case", ["dtype", "halo_dtype", "halo_shape",
                                  "strided_rows", "strided_halo"])
def test_block_candidates_cuda_rejects(case):
    rows = torch.zeros((2, 64), dtype=torch.uint8)
    halo = torch.zeros((2, HALO), dtype=torch.int64)
    args = {"dtype": (rows.to(torch.int16), halo),
            "halo_dtype": (rows, halo.to(torch.int32)),
            "halo_shape": (rows, halo[:, :30]),
            "strided_rows": (rows[:, ::2], halo),
            "strided_halo": (rows, torch.zeros((HALO, 2),
                                               dtype=torch.int64).t())}[case]
    with pytest.raises(ValueError):
        block_candidates_cuda(*args, 13)


@pytest.mark.parametrize("case", ["dtype", "ndim", "lanes", "strided"])
def test_index_best_cuda_rejects(case):
    sigs = torch.zeros((4, 8), dtype=torch.int32)
    index = torch.zeros((6, 8), dtype=torch.int32)
    args = {"dtype": (sigs.to(torch.int64), index),
            "ndim": (sigs.view(-1), index),
            "lanes": (sigs, index[:, :4].contiguous()),
            "strided": (sigs, torch.zeros((8, 6), dtype=torch.int32).t())
            }[case]
    with pytest.raises(ValueError):
        index_best_cuda(*args)


@pytest.mark.parametrize("source,symbol", [
    ("gear_cdc.cu", "fdfs_gear_candidates"),
    ("gear_cdc.cu", "fdfs_gear_block_mask"),
    ("index_query.cu", "fdfs_index_best"),
])
def test_build_names_the_new_sources_and_their_signatures(source, symbol):
    assert source in [p.name for p in _build.sources()]
    text = (_build.CSRC / source).read_text()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert decl is not None
    assert len(decl.group(1).split(",")) == len(_build._SIGNATURES[symbol])
