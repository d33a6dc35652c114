"""MinHash at shingle widths other than 5: the port against the JAX
package, both on the CPU.

Stages 1-3 (``ops.minhash.survivor_ragged`` and ``survivor_segmin``, and
the kernel wrappers ``survivor_ragged_cuda`` and ``survivor_segmin_cuda``,
which take their plain twins for CPU tensors) against the reference's XLA
``survivor_segmin`` at k = 1, 2, 3, 4, 6, 8, 13 and 32, on chunks of
lengths 0, 1, k - 1, k, k + 1 and a few hundred bytes, each at a start
offset of every residue mod 4 with non-zero bytes around it; the fused
sketch wrappers (``sketch_ragged_cuda(..., k=k)``, with and without
``order`` and ``z``, and ``minhash_batch_cuda(data, lens, 64, k)``) on
the same chunks against the reference's ``minhash_batch(data, lens, 64,
k)``; the engine at ``shingle=8`` (32 permutations too) and at
``shingle=4`` against the reference engine; the ingest step at
``shingle=4`` against the reference's on a 1-rank mesh, and the port's
8-rank mesh against the same.  The shapes are those the suites already
compile (the reference's SHA-1 costs minutes of XLA compile per new
shape).  Tolerance: exact equality (integer hashes, digests and
signatures; best similarities are ``k / 64`` in float32 on both sides).
"""

import functools

import numpy as np
import pytest
import torch

from fastdfs_tpu.dedup import DedupConfig as JConfig
from fastdfs_tpu.dedup import DedupEngine as JEngine
from fastdfs_tpu.ops import minhash as jm
from fastdfs_tpu.parallel import distributed_ingest_step as jingest_step
from fastdfs_tpu.parallel import make_mesh as jmake_mesh
from fastdfs_tpu_torch.dedup import DedupConfig, DedupEngine
from fastdfs_tpu_torch.ops import minhash as tm
from fastdfs_tpu_torch.ops.cuda_minhash import (minhash_batch_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.parallel import make_ingest_step, make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHINGLES = [1, 2, 3, 4, 6, 8, 13, 32]
WIDTH = 512


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _chunks(k: int):
    """(rows, lens, seg, offsets, reference z): uint8 rows of WIDTH bytes
    zero past their lengths, the same chunks laid into one segment (chunk
    i at an offset of residue i mod 4, non-zero bytes between), and the
    reference's z of the rows."""
    rng = np.random.RandomState(k)
    lens = np.array([0, 1, k - 1, k, k + 1, 300 + k, WIDTH - 1, WIDTH],
                    np.int32)
    rows = rng.randint(0, 256, (len(lens), WIDTH), dtype=np.uint8)
    rows[np.arange(WIDTH)[None, :] >= lens[:, None]] = 0
    seg = bytearray()
    offsets = []
    for i, n in enumerate(lens):
        seg += rng.randint(1, 256, 1 + (i - len(seg) - 1) % 4,
                           dtype=np.uint8).tobytes()
        offsets.append(len(seg))
        seg += rows[i, :n].tobytes()
    seg += rng.randint(1, 256, 3, dtype=np.uint8).tobytes()
    z = np.asarray(jm.survivor_segmin(rows, lens, k))
    return rows, lens, bytes(seg), np.array(offsets, np.int64), z


@pytest.mark.parametrize("k", SHINGLES)
def test_ragged_stages_1_to_3_match_reference(k):
    _, lens, seg, offsets, z = _chunks(k)
    t = (torch.from_numpy(np.frombuffer(seg, np.uint8).copy()),
         torch.from_numpy(offsets), torch.from_numpy(lens))
    assert (z != jm.EMPTY).any() and (z == jm.EMPTY).any()
    assert np.array_equal(_u32(tm.survivor_ragged(*t, k, row_tile=3)), z)
    order = torch.from_numpy(np.argsort(-lens, kind="stable")
                             .astype(np.int32))
    before = survivor_ragged_cuda.launches
    for got in (survivor_ragged_cuda(*t, k, row_tile=5),
                survivor_ragged_cuda(*t, k=k, order=order)):
        assert np.array_equal(_u32(got), z)
    assert survivor_ragged_cuda.launches == before   # the CPU twin


@pytest.mark.parametrize("k", SHINGLES)
def test_padded_stages_1_to_3_match_reference(k):
    rows, lens, _, _, z = _chunks(k)
    d, ln = torch.from_numpy(rows), torch.from_numpy(lens)
    assert np.array_equal(_u32(tm.survivor_segmin(d, ln, k)), z)
    before = survivor_segmin_cuda.launches
    assert np.array_equal(_u32(survivor_segmin_cuda(d, ln, k)), z)
    assert survivor_segmin_cuda.launches == before
    assert tm.survivor_ragged.cuda_calls == tm.survivor_segmin.cuda_calls == 0


@functools.lru_cache(maxsize=None)
def _reference_signatures(k: int) -> np.ndarray:
    rows, lens, _, _, _ = _chunks(k)
    return np.asarray(jm.minhash_batch(rows, lens, 64, k))


@pytest.mark.parametrize("k", SHINGLES)
def test_fused_sketch_matches_reference(k):
    rows, lens, seg, offsets, z = _chunks(k)
    want = _reference_signatures(k)
    assert len(np.unique(want, axis=0)) > 1
    t = (torch.from_numpy(np.frombuffer(seg, np.uint8).copy()),
         torch.from_numpy(offsets), torch.from_numpy(lens))
    order = torch.from_numpy(np.argsort(-lens, kind="stable")
                             .astype(np.int32))
    before = (sketch_ragged_cuda.launches, minhash_batch_cuda.launches)
    assert np.array_equal(_u32(sketch_ragged_cuda(*t, k=k, row_tile=3)), want)
    sig, got_z = sketch_ragged_cuda(*t, tm.perm_words(64, "cpu"), order,
                                    k=k, with_z=True)
    assert np.array_equal(_u32(sig), want) and np.array_equal(_u32(got_z), z)
    out = torch.full((len(lens), 70), 7, dtype=torch.int32)
    sketch_ragged_cuda(*t, None, None, out[:, 3:67], k=k)
    assert np.array_equal(_u32(out[:, 3:67].contiguous()), want)
    assert (out[:, :3] == 7).all() and (out[:, 67:] == 7).all()
    batch = minhash_batch_cuda(torch.from_numpy(rows), torch.from_numpy(lens),
                               64, k)
    assert np.array_equal(_u32(batch), want)
    assert (sketch_ragged_cuda.launches,
            minhash_batch_cuda.launches) == before  # the CPU twins
    with pytest.raises(ValueError):
        sketch_ragged_cuda(*t, k=0)


def test_engine_at_shingle_8_matches_reference():
    # test_torch_engine.py's stream and geometry: the reference's SHA-1
    # buckets are compiled there already.
    data = np.random.RandomState(1).randint(0, 256, size=20_000,
                                            dtype=np.uint8).tobytes()
    geo = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
    ours = DedupEngine(DedupConfig(**geo, shingle=8),
                       device="cpu").fingerprint(data)
    ref = JEngine(JConfig(**geo, shingle=8)).fingerprint(data)
    assert ours[0] == ref[0]
    assert np.array_equal(ours[1], ref[1])
    assert np.array_equal(ours[2], ref[2])
    at5 = DedupEngine(DedupConfig(**geo), device="cpu").fingerprint(data)
    assert not np.array_equal(ours[2], at5[2])


@functools.lru_cache(maxsize=None)
def _step_inputs_and_reference():
    """tests/test_parallel.py's 1-device inputs and the reference step's
    outputs at shingle 4."""
    rng = np.random.RandomState(1)
    stream = rng.randint(0, 256, size=(2, 1, 512), dtype=np.uint8)
    chunks = rng.randint(0, 256, size=(8, 256), dtype=np.uint8)
    lens = np.full(8, 256, np.int32)
    index = rng.randint(0, 2**32, size=(4, 64),
                        dtype=np.uint64).astype(np.uint32)
    args = (stream, chunks, lens, index)
    ref = [np.asarray(x) for x in jingest_step(jmake_mesh(1), *args,
                                                shingle=4)]
    return args, ref


@pytest.mark.parametrize("n", [1, 8])
def test_ingest_step_at_shingle_4_matches_reference(n):
    (stream, chunks, lens, index), ref = _step_inputs_and_reference()
    mesh = make_mesh(n, devices=["cpu"] * n)
    sp = mesh.shape["sp"]
    cand, digests, sigs, best = make_ingest_step(mesh, shingle=4)(
        stream.reshape(2, sp, -1), chunks, lens, index)
    assert np.array_equal(cand.numpy().reshape(ref[0].shape), ref[0])
    assert np.array_equal(_u32(digests), ref[1])
    assert np.array_equal(_u32(sigs), ref[2])
    assert np.array_equal(best.numpy(), ref[3])
    assert np.array_equal(_u32(sigs), _u32(tm.minhash_batch(
        torch.from_numpy(chunks), torch.from_numpy(lens), 64, 4)))


def test_engine_at_shingle_4_matches_reference():
    # The shingle-8 test's stream and geometry, 64 permutations: the
    # fused sketch at width 4 on the card, its plain twin here.
    data = np.random.RandomState(1).randint(0, 256, size=20_000,
                                            dtype=np.uint8).tobytes()
    geo = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
    engine = DedupEngine(DedupConfig(**geo, shingle=4), device="cpu")
    assert engine._fused
    ours = engine.fingerprint(data)
    ref = JEngine(JConfig(**geo, shingle=4)).fingerprint(data)
    assert ours[0] == ref[0]
    assert np.array_equal(ours[1], ref[1])
    assert np.array_equal(ours[2], ref[2])
