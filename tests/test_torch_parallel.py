"""The port's parallel/ (fastdfs_tpu_torch.parallel) against the JAX
package's, both on the CPU: mesh factoring, the distributed ingest step
output for output at every mesh size the reference tests use (with their
seeds and shapes, so the persistent XLA cache serves the reference's
compiles), cut candidates within a window of a block seam and of a
stream's start, the empty index, the fingerprint fan-out, and the
collectives.

The port's ranks are ``["cpu"] * n``; the reference's are the 8 virtual
CPU devices of tests/conftest.py.  Tolerance: exact equality (integer
digests, signatures and candidates; best similarities are ``k / 64`` in
float32 on both sides).
"""

import hashlib

import numpy as np
import pytest
import torch

from fastdfs_tpu.ops.gear_cdc import candidate_mask as jcandidate_mask
from fastdfs_tpu.ops.gear_cdc import gear_hashes as jgear_hashes
from fastdfs_tpu.ops.minhash import minhash_batch as jminhash_batch
from fastdfs_tpu.parallel import distributed_ingest_step as jingest_step
from fastdfs_tpu.parallel import factorize_devices as jfactorize
from fastdfs_tpu.parallel import make_mesh as jmake_mesh
from fastdfs_tpu.parallel.ingest_step import fingerprint_mesh as jfp_mesh
from fastdfs_tpu.parallel.ingest_step import (
    make_fingerprint_step as jmake_fp_step)
from fastdfs_tpu_torch.parallel import (distributed_ingest_step,
                                        factorize_devices, fingerprint_mesh,
                                        make_fingerprint_step,
                                        make_ingest_step, make_mesh)
from fastdfs_tpu_torch.parallel.collectives import all_gather, pmax, ppermute
from fastdfs_tpu_torch.parallel.ingest_step import index_best
from tests.torch_native import plant_candidate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small tensors: one intra-op thread per test worker keeps the
    # parallel test run from oversubscribing the CPU.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _u32(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _inputs(n, mesh_shape):
    """tests/test_parallel.py's inputs for an n-device mesh."""
    dp, sp = mesh_shape["dp"], mesh_shape["sp"]
    rng = np.random.RandomState(n)
    B, LBLK = 2 * dp, 512
    N, L, M, PERMS = 8 * dp, 256, 4 * dp, 64
    stream = rng.randint(0, 256, size=(B, sp, LBLK), dtype=np.uint8)
    chunks = rng.randint(0, 256, size=(N, L), dtype=np.uint8)
    lens = np.full(N, L, np.int32)
    index_sigs = rng.randint(0, 2**32, size=(M, PERMS),
                             dtype=np.uint64).astype(np.uint32)
    return stream, chunks, lens, index_sigs


_RUNS: dict = {}


def _ingest_runs(n):
    """(reference outputs, port outputs, port per-rank outputs) at n."""
    if n not in _RUNS:
        mesh = _cpu_mesh(n)
        args = _inputs(n, mesh.shape)
        ref = [np.asarray(x) for x in jingest_step(jmake_mesh(n), *args)]
        step = make_ingest_step(mesh)
        ranks = step.per_rank(*args)
        ours = [_u32(x) for x in step.assemble(ranks)]
        _RUNS[n] = ref, ours, ranks
    return _RUNS[n]


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_factorize_devices_matches_reference(n):
    assert factorize_devices(n) == jfactorize(n)
    assert factorize_devices(n, 2) == jfactorize(n, 2)


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_mesh_shape_and_ranks_match_reference(n):
    mesh = _cpu_mesh(n)
    ref = jmake_mesh(n)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == ref.axis_names
    assert mesh.size == n
    for r in range(n):
        assert mesh.device(r) == torch.device("cpu")
        assert np.unravel_index(r, mesh.devices.shape) == tuple(
            mesh.coords(r)[a] for a in mesh.axis_names)


def test_mesh_groups_along_each_axis():
    mesh = _cpu_mesh(8)                                   # (2, 2, 2)
    assert mesh.groups("dp").tolist() == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.groups("sp").tolist() == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert mesh.groups("tp").tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_mesh_asks_for_more_devices_than_given_or_visible():
    with pytest.raises(ValueError, match="asked for 4 devices, have 2"):
        make_mesh(4, devices=["cpu", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(ValueError, match="asked for 8 devices, have 0"):
        make_mesh(8)
    with pytest.raises(ValueError, match="have 0"):
        fingerprint_mesh(2)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _rank_tensors(n, width=3):
    return [torch.arange(width) + 10 * r for r in range(n)]


def test_ppermute_ring_along_sp():
    mesh = _cpu_mesh(8)
    out = ppermute(mesh, _rank_tensors(8), "sp", [(0, 1), (1, 0)])
    for group in mesh.groups("sp"):
        a, b = group
        assert torch.equal(out[a], torch.arange(3) + 10 * b)
        assert torch.equal(out[b], torch.arange(3) + 10 * a)


def test_ppermute_leaves_zeros_where_nothing_arrives():
    mesh = _cpu_mesh(8)
    out = ppermute(mesh, _rank_tensors(8), "dp", [(0, 1)])
    for src, dst in mesh.groups("dp"):
        assert torch.equal(out[dst], torch.arange(3) + 10 * src)
        assert torch.equal(out[src], torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("axis", ["dp", "sp", "tp"])
def test_all_gather_concatenates_in_axis_order(axis):
    mesh = _cpu_mesh(8)
    out = all_gather(mesh, [x[None] for x in _rank_tensors(8)], axis, 0)
    for group in mesh.groups(axis):
        want = torch.stack([torch.arange(3) + 10 * r for r in group])
        for r in group:
            assert torch.equal(out[r], want)


def test_pmax_is_elementwise_over_the_group():
    mesh = _cpu_mesh(4)                                   # (2, 2, 1)
    xs = [torch.tensor([r, 7 - r, 5]) for r in range(4)]
    out = pmax(mesh, xs, "dp")
    for group in mesh.groups("dp"):
        want = torch.maximum(xs[group[0]], xs[group[1]])
        for r in group:
            assert torch.equal(out[r], want)


# ---------------------------------------------------------------------------
# the distributed ingest step
# ---------------------------------------------------------------------------

OUTPUTS = ["cand", "digests", "sigs", "best"]


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_ingest_step_matches_reference(n, output):
    ref, ours, _ = _ingest_runs(n)
    i = OUTPUTS.index(output)
    assert ours[i].shape == ref[i].shape
    assert ours[i].dtype == ref[i].dtype
    assert np.array_equal(ours[i], ref[i])


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_every_rank_holds_the_same_replicated_outputs(n):
    _, _, ranks = _ingest_runs(n)
    for out in ranks[1:]:
        for a, b in zip(out[1:], ranks[0][1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_ingest_step_digests_are_hashlib(n):
    _, ours, _ = _ingest_runs(n)
    chunks = _inputs(n, _cpu_mesh(n).shape)[1]
    want = [hashlib.sha1(row.tobytes()).digest() for row in chunks]
    assert [d.astype(">u4").tobytes() for d in ours[1]] == want


@pytest.mark.parametrize("n,where", [(8, "start"), (8, "seam"), (4, "start"),
                                     (4, "seam"), (2, "start"), (1, "start")])
def test_candidates_within_a_window_of_a_seam_or_the_start(n, where):
    # The ring passes gear values: a first block padded with zero BYTES
    # would get the first 31 positions wrong (byte 0 hashes to
    # fmix32(1), not 0).
    mesh = _cpu_mesh(n)
    stream, chunks, lens, index = _inputs(n, mesh.shape)
    lblk = stream.shape[2]
    seams = ([0] if where == "start"
             else [s * lblk for s in range(1, mesh.shape["sp"])])
    planted = [s + d for s in seams for d in (1, 5, 17, 30)]
    for b in range(stream.shape[0]):
        full = stream[b].reshape(-1)
        for p in planted:
            plant_candidate(full, p, 13)
        stream[b] = full.reshape(stream.shape[1:])
    cand = distributed_ingest_step(mesh, stream, chunks, lens, index)[0]
    for b in range(stream.shape[0]):
        want = np.asarray(jcandidate_mask(jgear_hashes(stream[b].reshape(-1))))
        assert want[planted].all()
        assert np.array_equal(cand[b].reshape(-1).numpy(), want)


def test_empty_index_matches_reference():
    mesh = _cpu_mesh(2)
    rng = np.random.RandomState(0)
    stream = rng.randint(0, 256, size=(2, mesh.shape["sp"], 256),
                         dtype=np.uint8)
    chunks = rng.randint(0, 256, size=(2, 128), dtype=np.uint8)
    lens = np.full(2, 128, np.int32)
    empty = np.zeros((0, 64), dtype=np.uint32)
    ref = jingest_step(jmake_mesh(2), stream, chunks, lens, empty)
    ours = distributed_ingest_step(mesh, stream, chunks, lens, empty)
    for a, b in zip(ours, ref):
        assert np.array_equal(_u32(a), np.asarray(b))
    assert np.all(ours[3].numpy() == 0.0)


@pytest.mark.parametrize("n", [8, 4, 1])
def test_empty_index_scores_zero(n):
    mesh = _cpu_mesh(n)
    stream, chunks, lens, _ = _inputs(n, mesh.shape)
    best = distributed_ingest_step(mesh, stream, chunks, lens,
                                   np.zeros((0, 64), np.uint32))[3]
    assert best.dtype == torch.float32
    assert np.all(best.numpy() == 0.0)


def test_index_query_tiles_equal_the_dense_score(monkeypatch):
    from fastdfs_tpu_torch.ops import cuda_index

    rng = np.random.RandomState(9)
    index = rng.randint(0, 4, size=(37, 8)).astype(np.int32)
    sigs = np.concatenate([index[[3, 30]], rng.randint(0, 4, size=(11, 8))
                           .astype(np.int32)])
    dense = (sigs[:, None] == index[None]).mean(axis=2, dtype=np.float32
                                                ).max(axis=1)
    monkeypatch.setattr(cuda_index, "QUERY_PAIRS", 5)    # many small tiles
    got = index_best(torch.from_numpy(sigs), torch.from_numpy(index))
    assert np.array_equal(got.numpy(), dense)
    assert got[0] == 1.0 and got[1] == 1.0


def _raises_case(case):
    mesh = _cpu_mesh(8)                                   # (2, 2, 2)
    stream, chunks, lens, index = _inputs(8, mesh.shape)
    if case == "perms_vs_tp":
        make_ingest_step(mesh, num_perms=63)
    elif case == "rows_vs_dp":
        distributed_ingest_step(mesh, stream, chunks[:3], lens[:3], index)
    elif case == "streams_vs_dp":
        distributed_ingest_step(mesh, stream[:3], chunks, lens, index)
    elif case == "index_vs_dp":
        distributed_ingest_step(mesh, stream, chunks, lens, index[:3])
    elif case == "blocks_vs_sp":
        distributed_ingest_step(mesh, stream.reshape(4, 1, -1), chunks,
                                lens, index)
    elif case == "block_under_halo":
        distributed_ingest_step(mesh, stream[:, :, :20], chunks, lens, index)
    elif case == "fingerprint_rows_vs_dp":
        step = make_fingerprint_step(fingerprint_mesh(2, devices=["cpu"] * 2))
        step(chunks[:3], lens[:3])
    elif case == "fingerprint_mesh_axes":
        make_fingerprint_step(mesh)


@pytest.mark.parametrize("case", [
    "perms_vs_tp", "rows_vs_dp", "streams_vs_dp", "index_vs_dp",
    "blocks_vs_sp", "block_under_halo", "fingerprint_rows_vs_dp",
    "fingerprint_mesh_axes"])
def test_ingest_step_rejects_what_shard_map_would(case):
    with pytest.raises(ValueError):
        _raises_case(case)


# ---------------------------------------------------------------------------
# the fingerprint fan-out
# ---------------------------------------------------------------------------

def _fp_inputs():
    """tests/test_cdc_kernels.py's fan-out inputs."""
    rng = np.random.RandomState(3)
    N, L = 16, 256
    batch = np.zeros((N, L), dtype=np.uint8)
    lens = rng.randint(1, L + 1, N).astype(np.int32)
    for i in range(N):
        batch[i, :lens[i]] = rng.randint(0, 256, lens[i], dtype=np.uint8)
    return batch, lens


@pytest.mark.parametrize("n", [1, 2, 8])
def test_fingerprint_step_matches_reference(n):
    batch, lens = _fp_inputs()
    ref_d, ref_s = jmake_fp_step(jfp_mesh(n), num_perms=16, shingle=5)(
        batch, lens)
    d, s = make_fingerprint_step(fingerprint_mesh(n, devices=["cpu"] * n),
                                 num_perms=16, shingle=5)(batch, lens)
    assert np.array_equal(_u32(d), np.asarray(ref_d))
    assert np.array_equal(_u32(s), np.asarray(ref_s))
    want = [hashlib.sha1(batch[i, :lens[i]].tobytes()).digest()
            for i in range(len(lens))]
    assert [x.astype(">u4").tobytes() for x in _u32(d)] == want


@pytest.mark.parametrize("n", [1, 2, 8])
def test_fingerprint_step_fused_perms_match_reference_minhash(n):
    # 64 permutations at k = 5: the path the fused kernel takes on a card.
    batch, lens = _fp_inputs()
    d, s = make_fingerprint_step(fingerprint_mesh(n, devices=["cpu"] * n))(
        batch, lens)
    assert np.array_equal(_u32(s), np.asarray(jminhash_batch(batch, lens,
                                                             64, 5)))
    assert d.shape == (16, 5)
