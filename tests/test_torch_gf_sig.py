"""The CPU routes of the port's GF(2^8) and MinHash stage-4 kernel
wrappers (``ops.cuda_gf.gf_matmul_cuda``, ``ops.cuda_minhash.
signature_tiles_cuda``) and the paths that now reach them, against the
JAX package: the GF product at edge shapes and on tensor views, encode
and rebuild from every loss pattern of RS(5, 3), stage 4 over a
tensor-parallel rank's slice of the permutations, the ingest step at
tp = 2, the fingerprint step and the engine at permutation counts other
than the fused kernel's 64; the wrappers' contract errors; and their C
entries against ``_build._SIGNATURES``.

The reference's whole ingest step is not run at 32 or 128 permutations:
every new permutation count would compile its shard_map SHA-1 anew
(minutes on the CPU), so its signatures are held to the reference's
``minhash_batch`` of the same rows, which is the reference's stage 3
over the same permutations, and its best scores to the reference's
``eq.mean`` computed in NumPy.  The reference's XLA ``gf_matmul`` runs
only at the shapes tests/test_torch_ec.py already compiles.

Inputs come from numpy with a seed.  Tolerance: exact equality (bytes
over a finite field, 32-bit hashes, float32 means of the same counts).
"""

import itertools
import re

import jax
import numpy as np
import pytest
import torch

from fastdfs_tpu.ops import minhash as jm
from fastdfs_tpu.ops import rs_code as jrs
from fastdfs_tpu_torch.dedup import DedupConfig, DedupEngine
from fastdfs_tpu_torch.ops import _build, rs_code as trs
from fastdfs_tpu_torch.ops import minhash as tm
from fastdfs_tpu_torch.ops.cuda_gf import gf_matmul_cuda
from fastdfs_tpu_torch.ops.cuda_minhash import signature_tiles_cuda
from fastdfs_tpu_torch.parallel import (fingerprint_mesh,
                                        make_fingerprint_step,
                                        make_ingest_step, make_mesh)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# GF(2^8) product
# ---------------------------------------------------------------------------

# (rows, k, L): L of 0, 1, 3, 17 and 4097 (not multiples of 4 or 16),
# rows past 32, rows and k at the field's limit of 255.
GF_SHAPES = [(2, 4, 0), (2, 4, 1), (4, 10, 3), (8, 32, 17), (32, 32, 4097),
             (40, 7, 17), (255, 1, 5), (1, 255, 3), (6, 4, 1024)]


@pytest.mark.parametrize("rows,k,length", GF_SHAPES,
                         ids=[f"r{r}-k{k}-L{n}" for r, k, n in GF_SHAPES])
def test_gf_cpu_route_matches_reference_np(rows, k, length):
    rng = np.random.default_rng(rows * 1000 + k * 10 + length)
    mat = rng.integers(0, 256, (rows, k), dtype=np.uint8)
    shards = rng.integers(0, 256, (k, length), dtype=np.uint8)
    before = gf_matmul_cuda.launches
    got = gf_matmul_cuda(mat, torch.from_numpy(shards))
    assert gf_matmul_cuda.launches == before
    assert got.dtype == torch.uint8 and tuple(got.shape) == (rows, length)
    assert np.array_equal(got.numpy(), jrs.gf_matmul_np(mat, shards))


def test_gf_cpu_route_holds_every_byte_value():
    # Every coefficient 0..255, 0 and 1 included, against every byte.
    mat = np.arange(256, dtype=np.uint8).reshape(32, 8)
    shards = np.tile(np.arange(256, dtype=np.uint8), (8, 2))
    got = gf_matmul_cuda(torch.from_numpy(mat), torch.from_numpy(shards))
    assert np.array_equal(got.numpy(), jrs.gf_matmul_np(mat, shards))


@pytest.mark.parametrize("view", ["rows_from_m", "every_other_row",
                                  "column_slice", "cat"])
def test_gf_cpu_route_on_views_and_out(view):
    k, m, length = 10, 4, 301
    rng = np.random.default_rng(17)
    d = torch.from_numpy(rng.integers(0, 256, (2 * k, length),
                                      dtype=np.uint8))
    shards = {"rows_from_m": d[m:m + k],
              "every_other_row": d[::2],
              "column_slice": d[:k, 3:290],
              "cat": torch.cat([d[m:k], d[:m]])}[view]
    pm = jrs.parity_matrix(k, m)
    out = torch.full((2 * m, shards.shape[1] + 2), 7, dtype=torch.uint8)
    got = gf_matmul_cuda(pm, shards, out[::2, 1:-1])
    assert got.data_ptr() == out[::2, 1:-1].data_ptr()
    want = jrs.gf_matmul_np(pm, shards.numpy())
    assert np.array_equal(got.numpy(), want)
    assert (out[1::2] == 7).all() and (out[:, 0] == 7).all()


@pytest.mark.parametrize("k,m,length", [(1, 1, 1), (4, 2, 1023)])
def test_gf_cpu_route_matches_reference_jax(k, m, length):
    # The shapes tests/test_torch_ec.py compiles (encode matrices, L
    # padded to 1024 by the reference).
    rng = np.random.default_rng(23 + length)
    shards = rng.integers(0, 256, (k, length), dtype=np.uint8)
    mat = jrs.encode_matrix(k, m)
    got = gf_matmul_cuda(mat, torch.from_numpy(shards))
    assert np.array_equal(got.numpy(), jrs.gf_matmul(mat, shards))


_K, _M, _L = 5, 3, 301
LOSSES = list(itertools.combinations(range(_K + _M), _M))


@pytest.fixture(scope="module")
def rs53():
    data = np.random.default_rng(53).integers(0, 256, (_K, _L),
                                              dtype=np.uint8)
    parity = trs.rs_encode(torch.from_numpy(data), _M, path="torch",
                           device="cpu")
    return data, parity


@pytest.mark.parametrize("lost", LOSSES,
                         ids=["lose" + "".join(map(str, x)) for x in LOSSES])
def test_rs53_rebuilds_from_every_loss(rs53, lost):
    data, parity = rs53
    assert np.array_equal(parity.numpy(), jrs.rs_encode(data, _M, path="np"))
    shards = torch.cat([torch.from_numpy(data), parity])
    present = [s for s in range(_K + _M) if s not in lost]
    survivors = torch.cat([shards[s:s + 1] for s in present])
    got = trs.rs_reconstruct(survivors, present, _K, _M, path="torch",
                             device="cpu")
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), data)
    want = jrs.rs_reconstruct(survivors.numpy(), present, _K, _M, path="np")
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# MinHash stage 4
# ---------------------------------------------------------------------------

def _z(seed: int, n: int = 24) -> np.ndarray:
    """Survivor vectors: mostly EMPTY with random survivors, rows 0 and
    1 all EMPTY, row 2 with one survivor, row 3 with every segment."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 2**32, (n, tm.NUM_SEGMENTS), dtype=np.uint64)
    z = z.astype(np.uint32)
    z[rng.random(z.shape) < 0.8] = tm.EMPTY
    z[:2] = tm.EMPTY
    z[2] = tm.EMPTY
    z[2, 1000] = 7
    z[3] = rng.integers(0, 2**32 - 1, tm.NUM_SEGMENTS, dtype=np.uint64)
    return z


def _reference_signatures(z: np.ndarray, p: int) -> np.ndarray:
    """The reference's stage 4 of each row over all p permutations."""
    sign = jax.vmap(lambda zr: jm.minhash_signature(zr, p, zr != jm.EMPTY))
    return np.asarray(sign(z))


# (P, tp, the rank's tp index): whole counts, odd ones, and the slices a
# tensor-parallel rank signs.
SLICES = [(1, 1, 0), (7, 1, 0), (33, 1, 0), (100, 1, 0), (64, 1, 0),
          (64, 2, 0), (64, 2, 1), (64, 4, 3), (32, 2, 1), (128, 2, 0)]


@pytest.mark.parametrize("p,tp,t", SLICES,
                         ids=[f"P{p}-tp{tp}-rank{t}" for p, tp, t in SLICES])
def test_stage4_cpu_route_matches_reference_over_a_slice(p, tp, t):
    z = _z(p * 10 + t)
    p_local = p // tp
    cols = slice(t * p_local, (t + 1) * p_local)
    words = tm.perm_words(p, "cpu")[:, cols].contiguous()
    before = signature_tiles_cuda.launches
    got = signature_tiles_cuda(torch.from_numpy(z), words, row_tile=8)
    assert signature_tiles_cuda.launches == before
    want = _reference_signatures(z, p)[:, cols]
    assert got.dtype == torch.uint32 and np.array_equal(_u32(got), want)
    assert (want[:2] == jm.EMPTY).all()


def test_stage4_cpu_route_writes_a_strided_out():
    z = _z(5)
    words = tm.perm_words(32, "cpu")
    out = torch.full((12, 40), 9, dtype=torch.int32)
    zt = torch.from_numpy(z)[::2]
    got = signature_tiles_cuda(zt, words, out[:, 3:35])
    assert got.data_ptr() == out[:, 3:35].data_ptr()
    assert np.array_equal(_u32(got), _reference_signatures(z, 32)[::2])
    assert (out[:, :3] == 9).all() and (out[:, 35:] == 9).all()
    assert signature_tiles_cuda(zt[:0], words).shape == (0, 32)


def _rows(seed: int, n: int, length: int):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 256, (n, length), dtype=np.uint8)
    lens = rng.randint(0, length + 1, n).astype(np.int32)
    lens[:3] = [0, 1, length]
    rows[np.arange(length)[None, :] >= lens[:, None]] = 0
    return rows, lens


@pytest.mark.parametrize("perms", [32, 128])
def test_ingest_step_at_tp2_matches_reference_stage3(perms):
    rows, lens = _rows(perms, 16, 1024)
    rng = np.random.RandomState(perms + 1)
    stream = rng.randint(0, 256, (2, 2, 512), dtype=np.uint8)
    want = np.asarray(jm.minhash_batch(rows, lens, perms, 5))
    index = np.concatenate([want[:4], rng.randint(
        0, 2**32, (4, perms), dtype=np.uint64).astype(np.uint32)])
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape["tp"] == 2
    step = make_ingest_step(mesh, num_perms=perms)
    ranks = step.per_rank(stream, rows, lens, index)
    for r, out in enumerate(ranks):
        assert out[2].shape == (16, perms), r
    _, _, sigs, best = step.assemble(ranks)
    assert np.array_equal(_u32(sigs), want)
    eq = want[:, None, :] == index[None, :, :]
    dense = eq.mean(axis=2, dtype=np.float32).max(axis=1)
    assert np.array_equal(best.numpy(), dense)
    assert (best.numpy()[:4] == 1.0).all()


@pytest.mark.parametrize("perms", [32, 128])
def test_fingerprint_step_at_other_counts_matches_reference(perms):
    rows, lens = _rows(perms + 7, 8, 1024)
    _, sigs = make_fingerprint_step(fingerprint_mesh(2, devices=["cpu"] * 2),
                                    num_perms=perms)(rows, lens)
    assert np.array_equal(_u32(sigs),
                          np.asarray(jm.minhash_batch(rows, lens, perms, 5)))


@pytest.mark.parametrize("perms", [32, 128])
def test_engine_at_other_counts_matches_reference_stage3(perms):
    rng = np.random.RandomState(perms)
    data = rng.randint(0, 256, 9000, dtype=np.uint8).tobytes()
    cuts = [100, 1500, 1501, 4000, 9000]
    eng = DedupEngine(DedupConfig(min_size=64, avg_bits=8, max_size=4096,
                                  row_tile=32, num_perms=perms), device="cpu")
    spans, _, sigs = eng.fingerprint(data, cuts=cuts)
    rows = np.zeros((len(spans), max(n for _, n in spans)), np.uint8)
    lens = np.zeros(len(spans), np.int32)
    for i, (o, n) in enumerate(spans):
        rows[i, :n] = np.frombuffer(data[o:o + n], np.uint8)
        lens[i] = n
    assert np.array_equal(sigs, np.asarray(jm.minhash_batch(rows, lens,
                                                            perms, 5)))


# ---------------------------------------------------------------------------
# Contract errors and the build table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["matrix_dtype", "matrix_ndim", "too_many_rows",
                                  "shards_dtype", "shards_k", "shards_stride",
                                  "out_shape", "out_dtype", "out_stride"])
def test_gf_wrapper_rejects(case):
    mat = np.ones((3, 4), np.uint8)
    shards = torch.zeros((4, 16), dtype=torch.uint8)
    out = torch.zeros((3, 16), dtype=torch.uint8)
    args = {"matrix_dtype": (mat.astype(np.int32), shards, None),
            "matrix_ndim": (mat[0], shards, None),
            "too_many_rows": (np.ones((256, 4), np.uint8), shards, None),
            "shards_dtype": (mat, shards.to(torch.int16), None),
            "shards_k": (mat, shards[:3], None),
            "shards_stride": (mat, torch.zeros((16, 4), dtype=torch.uint8).t(),
                              None),
            "out_shape": (mat, shards, out[:2]),
            "out_dtype": (mat, shards, out.to(torch.int32)),
            "out_stride": (mat, shards,
                           torch.zeros((16, 3), dtype=torch.uint8).t()),
            }[case]
    with pytest.raises(ValueError):
        gf_matmul_cuda(*args)


@pytest.mark.parametrize("case", ["z_dtype", "z_width", "z_stride",
                                  "words_dtype", "words_rows", "words_empty",
                                  "words_strided", "out_shape", "out_stride"])
def test_stage4_wrapper_rejects(case):
    z = torch.zeros((4, tm.NUM_SEGMENTS), dtype=torch.int32)
    words = tm.perm_words(8, "cpu")
    out = torch.zeros((4, 8), dtype=torch.int32)
    args = {"z_dtype": (z.to(torch.int64), words, None),
            "z_width": (z[:, :512], words, None),
            "z_stride": (torch.zeros((tm.NUM_SEGMENTS, 4),
                                     dtype=torch.int32).t(), words, None),
            "words_dtype": (z, words.to(torch.int64), None),
            "words_rows": (z, torch.zeros((3, 8), dtype=torch.int32), None),
            "words_empty": (z, words[:, :0].contiguous(), None),
            "words_strided": (z, tm.perm_words(16, "cpu")[:, ::2], None),
            "out_shape": (z, words, out[:, :4]),
            "out_stride": (z, words, torch.zeros((8, 4),
                                                 dtype=torch.int32).t()),
            }[case]
    with pytest.raises(ValueError):
        signature_tiles_cuda(*args)


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.gf_matmul(trs.parity_matrix(4, 2), np.zeros((4, 8), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.rs_reconstruct(np.zeros((4, 8), np.uint8), [2, 3, 4, 5], 4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DedupEngine(DedupConfig(num_perms=32))


@pytest.mark.parametrize("source,symbol", [
    ("gf_matmul.cu", "fdfs_gf_matmul"),
    ("minhash_sig.cu", "fdfs_minhash_sig"),
])
def test_build_names_the_new_sources_and_their_signatures(source, symbol):
    assert source in [p.name for p in _build.sources()]
    text = (_build.CSRC / source).read_text()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert decl is not None
    assert len(decl.group(1).split(",")) == len(_build._SIGNATURES[symbol])
