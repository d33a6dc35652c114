"""The port's Reed-Solomon codec (fastdfs_tpu_torch.ops.gf256, rs_code)
against the JAX package's: field tables, generator and decode matrices,
the GF(2^8) matmul in all its disciplines, and reconstruction from every
loss pattern.

Tolerance: exact equality (bytes over a finite field).  The port's
``gf_matmul`` runs on the CPU here; the reference's JAX ``gf_matmul`` is
compiled only at shapes tests/test_ec.py already compiles.
"""

import itertools

import numpy as np
import pytest
import torch

from fastdfs_tpu.ops import gf256 as jgf
from fastdfs_tpu.ops import rs_code as jrs
from fastdfs_tpu_torch.ops import gf256 as tgf
from fastdfs_tpu_torch.ops import rs_code as trs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


GEOMETRIES = [(1, 1), (3, 2), (4, 2), (5, 3), (10, 4), (32, 8)]
# tests/test_ec.py's adversarial (k, m, length): k = 1, lengths around the
# reference's power-of-two pad, a tile-straddling length.
ADVERSARIAL = [(1, 1, 1), (2, 1, 3), (3, 2, 33), (4, 2, 1023),
               (5, 3, 1024), (8, 4, 1025), (17, 5, 4099), (32, 8, 257)]


@pytest.mark.parametrize("name", ["GF_EXP", "GF_LOG", "POLY"])
def test_field_tables_match_reference(name):
    assert getattr(tgf, name) == getattr(jgf, name)


def test_product_table_matches_reference():
    assert trs.PROD_TABLE.dtype == jrs.PROD_TABLE.dtype
    assert np.array_equal(trs.PROD_TABLE, jrs.PROD_TABLE)
    assert trs.MAX_SHARDS == jrs.MAX_SHARDS


def test_scalar_field_ops_match_reference():
    for a in range(256):
        for b in range(0, 256, 7):
            assert tgf.gf_mul(a, b) == jgf.gf_mul(a, b)
            if b:
                assert tgf.gf_div(a, b) == jgf.gf_div(a, b)
        if a:
            assert tgf.gf_inv(a) == jgf.gf_inv(a)
    for k, j, i in itertools.product((3, 10, 32), range(4), range(3)):
        assert tgf.cauchy_coeff(k, j, i) == jgf.cauchy_coeff(k, j, i)


@pytest.mark.parametrize("fn", ["parity_matrix", "encode_matrix",
                                "invert_matrix"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_matrices_match_reference(fn, k, m):
    if fn == "invert_matrix":
        # The square generator rows left after losing the first m shards.
        rows = np.arange(m, k + m)
        got = trs.gf_invert_matrix(trs.encode_matrix(k, m)[rows])
        want = jrs.gf_invert_matrix(jrs.encode_matrix(k, m)[rows])
    else:
        got = getattr(trs, fn)(k, m)
        want = getattr(jrs, fn)(k, m)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,m,length", ADVERSARIAL,
                         ids=[f"k{k}-m{m}-L{n}" for k, m, n in ADVERSARIAL])
def test_gf_matmul_matches_reference_np(k, m, length):
    rng = np.random.default_rng(7 + k * 1000 + length)
    shards = rng.integers(0, 256, (k, length), dtype=np.uint8)
    mat = jrs.encode_matrix(k, m)
    got = trs.gf_matmul(mat, shards, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert np.array_equal(got, jrs.gf_matmul_np(mat, shards))
    assert np.array_equal(trs.gf_matmul_np(mat, shards), got)
    if k * length <= 4096:  # the referee is O(rows * k * L) Python
        assert np.array_equal(trs.gf_matmul_ref(mat, shards), got)


@pytest.mark.parametrize("k,m,length", [(1, 1, 1), (4, 2, 1023)])
def test_gf_matmul_matches_reference_jax(k, m, length):
    rng = np.random.default_rng(11 + length)
    shards = rng.integers(0, 256, (k, length), dtype=np.uint8)
    mat = jrs.encode_matrix(k, m)
    assert np.array_equal(trs.gf_matmul(mat, shards, device="cpu"),
                          jrs.gf_matmul(mat, shards))


_K, _M, _L = 4, 2, 511
LOSSES = list(itertools.combinations(range(_K + _M), _M))


@pytest.mark.parametrize("lost", LOSSES, ids=[f"lose{a}{b}" for a, b in LOSSES])
def test_every_two_losses_reconstruct(lost):
    rng = np.random.default_rng(42)
    data = rng.integers(0, 256, (_K, _L), dtype=np.uint8)
    parity = trs.rs_encode(data, _M, device="cpu")
    assert np.array_equal(parity, jrs.rs_encode(data, _M, path="np"))
    shards = np.concatenate([data, parity])
    present = [s for s in range(_K + _M) if s not in lost]
    got = trs.rs_reconstruct(shards[np.asarray(present)], present, _K, _M,
                             path="torch", device="cpu")
    assert np.array_equal(got, data)
    assert np.array_equal(got, jrs.rs_reconstruct(
        shards[np.asarray(present)], present, _K, _M, path="np"))


@pytest.mark.parametrize("path", ["ref", "np", "torch"])
def test_rs_encode_paths_match_reference(path):
    data = np.random.default_rng(3).integers(0, 256, (3, 40), dtype=np.uint8)
    got = trs.rs_encode(data, 2, path=path, device="cpu")
    assert np.array_equal(got, jrs.rs_encode(data, 2, path="np"))


def test_decode_matrix_refuses_too_few_shards():
    with pytest.raises(ValueError):
        trs.decode_matrix(_K, _M, [0, 1, 2])
    with pytest.raises(ValueError):
        trs.decode_matrix(_K, _M, [0, 1, 2, 2])
    with pytest.raises(ValueError):
        trs.rs_reconstruct(np.zeros((3, 8), np.uint8), [0, 1, 2], _K, _M,
                           device="cpu")


def test_geometry_and_path_errors():
    with pytest.raises(ValueError):
        trs.parity_matrix(250, 6)  # k + m > 255
    with pytest.raises(ValueError):
        trs.rs_encode(np.zeros((2, 4), np.uint8), 1, path="jax")
    with pytest.raises(ValueError):
        trs.gf_matmul(trs.parity_matrix(3, 2), np.zeros((2, 4), np.uint8),
                      device="cpu")


def test_zero_length_shape():
    mat = trs.parity_matrix(3, 2)
    empty = np.zeros((3, 0), dtype=np.uint8)
    assert trs.gf_matmul(mat, empty, device="cpu").shape == (2, 0)
    out = trs.gf_matmul(mat, torch.zeros((3, 0), dtype=torch.uint8))
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (2, 0)


def test_numpy_in_numpy_out_and_tensor_stays():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (5, 300), dtype=np.uint8)
    want = jrs.rs_encode(data, 3, path="np")
    got = trs.rs_encode(data, 3, device="cpu")
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    # A tensor is computed on its own device: the default device="cuda"
    # does not move it.
    t = torch.from_numpy(data)
    got_t = trs.rs_encode(t, 3)
    assert isinstance(got_t, torch.Tensor) and got_t.device == t.device
    assert got_t.dtype == torch.uint8
    assert np.array_equal(got_t.numpy(), want)
    back = trs.rs_reconstruct(torch.cat([t[3:], got_t]), [3, 4, 5, 6, 7],
                              5, 3)
    assert isinstance(back, torch.Tensor) and torch.equal(back, t)


def test_one_dimensional_shards_are_one_row():
    row = np.arange(50, dtype=np.uint8)
    assert np.array_equal(trs.rs_encode(row, 2, device="cpu"),
                          jrs.rs_encode(row, 2, path="np"))


def test_split_stripe_matches_reference():
    for data in (bytes(range(98)), b"", b"x", bytes(1000)):
        for k in (1, 3, 10):
            assert np.array_equal(trs.split_stripe(data, k),
                                  jrs.split_stripe(data, k))
    with pytest.raises(ValueError):
        trs.split_stripe(b"abc", 0)


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    data = np.zeros((3, 8), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.gf_matmul(trs.parity_matrix(3, 1), data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.rs_encode(data, 1)
