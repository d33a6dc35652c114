"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA card and skips without one; the mesh tests place every
virtual rank on that one card.  This file imports nothing of
JAX or the JAX package, so it also runs on a GPU host without JAX (where
tests/conftest.py, which imports JAX, cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Tolerance: exact equality (integer digests and hashes).
"""

import hashlib

import numpy as np
import pytest
import torch

from fastdfs_tpu_torch.client import fingerprint_buffer
from fastdfs_tpu_torch.dedup import stage_copy
from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine
from fastdfs_tpu_torch.entry import dryrun_multichip, entry
from fastdfs_tpu_torch.ops import SEGMENT_SLACK, minhash, rs_code, sha1, widen
from fastdfs_tpu_torch.ops.cuda_gf import gf_matmul_cuda
from fastdfs_tpu_torch.ops.cuda_minhash import (minhash_batch_cuda,
                                                signature_tiles_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.ops.cuda_gear import (HALO, RUN, TILE,
                                             block_candidates_cuda,
                                             gear_candidates_cuda)
from fastdfs_tpu_torch.ops.cuda_index import index_best, index_best_cuda
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda, sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import (block_candidates,
                                            candidate_mask, chunk_stream,
                                            chunk_stream_np, gear_candidates,
                                            gear_candidates_np, gear_hashes,
                                            gear_hashes_np, gear_values,
                                            gear_window)
from fastdfs_tpu_torch.ops.streaming import stream_batches
from fastdfs_tpu_torch.parallel import (fingerprint_mesh,
                                        make_fingerprint_step,
                                        make_ingest_step, make_mesh)
# tests/ is on sys.path under pytest; a host may have another package
# named ``tests``, which would shadow this directory as a package.
from torch_native import (dense_pair, plant_candidate, plant_wide,
                          seam_plants, shingle_segment, wide_seam_plants)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(rng, n, L, edges):
    data = rng.randint(0, 256, size=(n, L), dtype=np.uint8)
    lens = rng.randint(1, L + 1, size=n).astype(np.int32)
    lens[:len(edges)] = edges
    data[np.arange(L)[None, :] >= lens[:, None]] = 0
    return data, lens


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2048, 65536])
def test_sha1_kernel_matches_plain_and_hashlib(cuda_device, L):
    data, lens = _batch(np.random.RandomState(L), 256, L,
                        [L, 0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120])
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    before = sha1_batch_cuda.launches
    got = sha1_batch_cuda(d, ln).view(torch.int32).cpu()
    assert sha1_batch_cuda.launches == before + 1
    assert torch.equal(got, sha1.sha1_batch(d, ln).view(torch.int32).cpu())
    raw = sha1.digest_bytes(got.numpy().view(np.uint32))
    for i in range(256):
        assert raw[i * 20:(i + 1) * 20] == \
            hashlib.sha1(data[i, :lens[i]].tobytes()).digest(), i


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2048, 8192, 65536])
def test_survivor_kernel_matches_plain(cuda_device, L):
    data, lens = _batch(np.random.RandomState(31 + L), 256, L,
                        [L, 0, 1, 2, 3, 4, 5, 6, 7, 8, L - 1])
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    before = survivor_segmin_cuda.launches
    got = survivor_segmin_cuda(d, ln).view(torch.int32).cpu()
    assert survivor_segmin_cuda.launches == before + 1
    assert torch.equal(got, minhash.survivor_segmin(d, ln).view(torch.int32).cpu())
    before = minhash_batch_cuda.launches
    got = minhash_batch_cuda(d, ln).view(torch.int32).cpu()
    assert minhash_batch_cuda.launches == before + 1
    assert torch.equal(got, minhash.minhash_batch(d, ln).view(torch.int32).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("perms", [64, 32])
def test_engine_on_card_matches_engine_on_cpu(cuda_device, perms):
    rng = np.random.RandomState(7)
    data = rng.randint(0, 256, size=300_000, dtype=np.uint8).tobytes()
    cfg = DedupConfig(min_size=64, avg_bits=8, max_size=1024, row_tile=32,
                      num_perms=perms)
    sketch = sketch_ragged_cuda if perms == 64 else survivor_ragged_cuda
    before = (sha1_ragged_cuda.launches, sketch.launches)
    spans, digests, sigs = DedupEngine(cfg, device=cuda_device).fingerprint(data)
    assert sha1_ragged_cuda.launches == before[0] + 1
    assert sketch.launches == before[1] + 1
    ref = DedupEngine(cfg, device="cpu").fingerprint(data)
    assert spans == ref[0]
    assert np.array_equal(digests, ref[1])
    assert np.array_equal(sigs, ref[2])


@pytest.mark.gpu
def test_engine_sliced_staging_copy_on_card(cuda_device, monkeypatch):
    """A segment long enough to slice goes through the kernel library's
    C++ copy pool: the staging holds its bytes and zeroed slack after a
    longer call, and the answers are those of the same segment copied
    inline, with digests as hashlib's."""
    rng = np.random.RandomState(21)
    longer = rng.randint(0, 256, size=(24 << 20) + 5, dtype=np.uint8)
    data = rng.randint(0, 256, size=(20 << 20) + 3,
                       dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(data, 2048, 13, 65536)
    eng = DedupEngine(device=cuda_device)
    eng.fingerprint(longer.tobytes(), cuts=[len(longer)])
    got = eng.fingerprint(data, cuts=cuts)
    staged = eng._thread().seg.numpy()
    assert np.array_equal(staged[:len(data)], np.frombuffer(data, np.uint8))
    assert not staged[len(data):len(data) + SEGMENT_SLACK].any()
    sliced = stage_copy._copiers() > 1
    assert eng.stage_counts["stage_sliced"] == (2 if sliced else 0)
    monkeypatch.setattr(stage_copy, "_SLICE_MIN", 1 << 40)
    want = DedupEngine(device=cuda_device).fingerprint(data, cuts=cuts)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])
    raw = got[1].astype(">u4").tobytes()
    for i in range(0, len(got[0]), 97):
        off, ln = got[0][i]
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(
            data[off:off + ln]).digest()


def _on_card(dev, seg: bytes, offsets, lens):
    """The segment with its zero slack, and its chunk table, on the card."""
    buf = np.zeros(len(seg) + SEGMENT_SLACK, np.uint8)
    buf[:len(seg)] = np.frombuffer(seg, np.uint8)
    order = np.argsort(-np.asarray(lens), kind="stable").astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in
            (buf, np.asarray(offsets, np.int64), np.asarray(lens, np.int32),
             order)]


def _edge_segment():
    """Lengths 0-8, 55-57, 63-65 and 1400 at every start offset mod 4,
    each followed by non-zero bytes, then one chunk past the 64 KiB
    max_size that ends the segment."""
    rng = np.random.RandomState(41)
    seg = bytearray()
    offsets, lens = [], []
    for align in range(4):
        for n in list(range(9)) + [55, 56, 57, 63, 64, 65, 1400, 66000]:
            if n == 66000 and align != 3:
                continue
            seg += rng.randint(1, 256, 1 + (align - len(seg) - 1) % 4,
                               dtype=np.uint8).tobytes()
            offsets.append(len(seg))
            lens.append(n)
            seg += rng.randint(1, 256, n, dtype=np.uint8).tobytes()
    return bytes(seg), offsets, lens


def _check_ragged(dev, seg, offsets, lens, row_tile):
    d_seg, d_off, d_len, d_ord = _on_card(dev, seg, offsets, lens)
    before = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
    digests = sha1_ragged_cuda(d_seg, d_off, d_len, d_ord)
    sigs = sketch_ragged_cuda(d_seg, d_off, d_len, None, d_ord)
    torch.cuda.synchronize()
    assert sha1_ragged_cuda.launches == before[0] + 1
    assert sketch_ragged_cuda.launches == before[1] + 1
    raw = sha1.digest_bytes(digests)
    for i, (o, n) in enumerate(zip(offsets, lens)):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(seg[o:o + n]).digest(), i
    plain_seg = d_seg[:len(seg)]  # the twins take no slack
    assert torch.equal(digests.view(torch.int32),
                       sha1.sha1_ragged(plain_seg, d_off, d_len,
                                        row_tile).view(torch.int32))
    plain_sig, plain_z = minhash.sketch_ragged(plain_seg, d_off, d_len,
                                               row_tile=row_tile, with_z=True)
    assert torch.equal(sigs.view(torch.int32), plain_sig.view(torch.int32))
    before = survivor_ragged_cuda.launches
    z = survivor_ragged_cuda(d_seg, d_off, d_len, order=d_ord)
    assert survivor_ragged_cuda.launches == before + 1
    assert torch.equal(z.view(torch.int32), plain_z.view(torch.int32))


@pytest.mark.gpu
def test_ragged_kernels_on_a_64mb_segment(cuda_device):
    seg = np.random.default_rng(20261016).integers(
        0, 256, 64 << 20, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(seg)
    offsets = [0] + cuts[:-1]
    lens = [b - a for a, b in zip(offsets, cuts)]
    _check_ragged(cuda_device, seg, offsets, lens, row_tile=4096)


@pytest.mark.gpu
def test_ragged_kernels_on_the_edge_segment(cuda_device):
    seg, offsets, lens = _edge_segment()
    _check_ragged(cuda_device, seg, offsets, lens, row_tile=64)


@pytest.mark.gpu
def test_one_chunk_as_large_as_the_segment(cuda_device):
    # One serial SHA-1 chain of 1M blocks: correct, and slow (PERF.md).
    seg = np.random.default_rng(5).integers(0, 256, 64 << 20,
                                            dtype=np.uint8).tobytes()
    d_seg, d_off, d_len, d_ord = _on_card(cuda_device, seg, [0], [len(seg)])
    digest = sha1_ragged_cuda(d_seg, d_off, d_len, d_ord)
    assert sha1.digest_bytes(digest) == hashlib.sha1(seg).digest()
    sig = sketch_ragged_cuda(d_seg, d_off, d_len, None, d_ord)
    plain = minhash.sketch_ragged(d_seg[:len(seg)], d_off, d_len)
    assert torch.equal(sig.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 22, (1 << 22) - 17])
def test_fingerprint_buffer_on_card_matches_cpu_route(cuda_device, n):
    # 2^22 bytes: the device pass's power-of-two buffer has no room of
    # its own past the payload, so the SHA-1 slack must come from the
    # upload.
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    before = sha1_ragged_cuda.launches
    got = fingerprint_buffer(data, device=cuda_device)
    assert sha1_ragged_cuda.launches == before + 1
    want = fingerprint_buffer(data, device="cpu")
    assert [(f.length, f.digest) for f in got] == \
        [(f.length, f.digest) for f in want]


@pytest.mark.gpu
def test_fingerprint_buffer_through_pinned_staging(cuda_device):
    """The client's 64 MB payload goes up from this thread's pinned
    staging, which the next call reuses; digests equal hashlib."""
    from fastdfs_tpu_torch.ops import gear_cdc

    rng = np.random.RandomState(64)
    payloads = [rng.randint(0, 256, size=1 << 26, dtype=np.uint8).tobytes(),
                rng.randint(0, 256, size=(1 << 26) - 999,
                            dtype=np.uint8).tobytes()]
    before = sha1_ragged_cuda.launches
    staging = []
    for data in payloads:
        fps = fingerprint_buffer(data, device=cuda_device)
        staging.append(gear_cdc._pinned.buf)
        assert staging[-1].is_pinned()
        cuts = chunk_stream_np(data)
        assert [f.length for f in fps] == np.diff([0] + cuts).tolist()
        starts = [0] + cuts[:-1]
        for f, a, b in zip(fps, starts, cuts):
            assert f.digest == hashlib.sha1(data[a:b]).digest()
    assert staging[0] is staging[1]
    assert sha1_ragged_cuda.launches == before + 2


@pytest.mark.gpu
def test_storage_client_on_the_card(cuda_device):
    """``device="cuda"`` resolves on a card and the client connects."""
    import socket

    from fastdfs_tpu_torch.client import FdfsClient, StorageClient

    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        sc = StorageClient("127.0.0.1", srv.getsockname()[1])
        assert sc.device.type == "cuda"
        sc.close()
    assert FdfsClient("127.0.0.1:1").device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(4, 2), (10, 4), (32, 8)])
def test_gf_matmul_on_card(cuda_device, k, m):
    shards = np.random.default_rng(k).integers(0, 256, (k, 100_003),
                                               dtype=np.uint8)
    pm = rs_code.parity_matrix(k, m)
    want = rs_code.gf_matmul_np(pm, shards)
    got = rs_code.gf_matmul(pm, shards, device=cuda_device)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    d = torch.from_numpy(shards).to(cuda_device)
    parity = rs_code.rs_encode(d, m)
    assert parity.device == d.device
    assert np.array_equal(parity.cpu().numpy(), want)
    back = rs_code.rs_reconstruct(torch.cat([d[m:], parity]),
                                  list(range(m, k + m)), k, m)
    assert torch.equal(back, d)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_stream_batches_through_the_sha1_kernel(cuda_device, depth):
    rng = np.random.RandomState(depth)
    batches = [_batch(rng, 256, 2048, [2048, 0, 1, 55, 56, 64])
               for _ in range(5)]
    got = list(stream_batches(iter(batches), sha1_batch_cuda, depth=depth,
                              device=cuda_device))
    assert len(got) == len(batches)
    for (data, lens), words in zip(batches, got):
        assert words.dtype == np.uint32
        raw = sha1.digest_bytes(words)
        for i in range(len(lens)):
            assert raw[i * 20:(i + 1) * 20] == \
                hashlib.sha1(data[i, :lens[i]].tobytes()).digest(), i


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _check_ingest_step(devices):
    """The ingest step over a mesh of ``devices`` (inputs on the first)
    against one rank, hashlib, the plain sketch and the whole streams'
    candidates."""
    dev, n = devices[0], len(devices)
    rng = np.random.RandomState(8)
    streams = torch.from_numpy(
        rng.randint(0, 256, (2, 2 << 20), dtype=np.uint8)).to(dev)
    data, lens = _batch(rng, 512, 4096, [4096, 0, 1, 55, 56, 64])
    d = torch.from_numpy(data).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    plain = _u32(minhash.minhash_batch(d, ln))
    index = np.concatenate([plain[:128], rng.randint(
        0, 2**32, (896, 64), dtype=np.uint64).astype(np.uint32)])
    mesh = make_mesh(n, devices=devices)
    sp = mesh.shape["sp"]
    sketches = (survivor_segmin_cuda, minhash_batch_cuda)
    before = (sha1_batch_cuda.launches, sum(f.launches for f in sketches))
    cand, digests, sigs, best = make_ingest_step(mesh)(
        streams.view(2, sp, -1), d, ln, index)
    torch.cuda.synchronize()
    assert (sha1_batch_cuda.launches - before[0],
            sum(f.launches for f in sketches) - before[1]) == (n, n)
    cand1, dig1, sig1, best1 = make_ingest_step(make_mesh(1, devices=[dev]))(
        streams.view(2, 1, -1), d, ln, index)
    for b in range(2):
        want = candidate_mask(widen(gear_hashes(streams[b])))
        assert torch.equal(cand[b].reshape(-1), want)
        assert torch.equal(cand1[b].reshape(-1), want)
    raw = sha1.digest_bytes(digests)
    for i in range(len(lens)):
        assert raw[i * 20:(i + 1) * 20] == \
            hashlib.sha1(data[i, :lens[i]].tobytes()).digest(), i
    assert np.array_equal(_u32(dig1), _u32(digests))
    assert np.array_equal(_u32(sigs), plain)
    assert np.array_equal(_u32(sig1), plain)
    assert torch.equal(best, best1)
    assert (best[:128] == 1.0).all()


@pytest.mark.gpu
def test_ingest_step_on_8_virtual_ranks_matches_1_rank(cuda_device):
    _check_ingest_step([cuda_device] * 8)


@pytest.mark.gpu
def test_ingest_step_across_cards_matches_1_rank(cards):
    _check_ingest_step(cards)


def _check_engine_fan_out(dev, k, devices=None):
    data = np.random.default_rng(k).integers(0, 256, 8 << 20,
                                             dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(data)
    want = DedupEngine(DedupConfig(fan_out=1), device=dev).fingerprint(
        data, cuts=cuts)
    eng = DedupEngine(DedupConfig(fan_out=k), device=dev, devices=devices)
    assert len(eng.devices) == k
    before = (sha1_ragged_cuda.launches, sketch_ragged_cuda.launches)
    got = eng.fingerprint(data, cuts=cuts)
    assert (sha1_ragged_cuda.launches - before[0],
            sketch_ragged_cuda.launches - before[1]) == (k, k)
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_engine_fan_out_on_card_matches_fan_out_1(cuda_device, k):
    _check_engine_fan_out(cuda_device, k, [cuda_device] * k)


@pytest.mark.gpu
def test_engine_fan_out_across_cards_matches_fan_out_1(cards):
    _check_engine_fan_out("cuda", len(cards))
    # fan_out=None takes every visible card.
    assert DedupEngine(device="cuda").devices == cards


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2])
def test_fingerprint_step_on_card_matches_the_kernels(cuda_device, n):
    _check_fingerprint_step(fingerprint_mesh(n, devices=[cuda_device] * n))


@pytest.mark.gpu
def test_fingerprint_step_and_dryrun_across_cards(cards):
    _check_fingerprint_step(fingerprint_mesh())
    dryrun_multichip(len(cards))


def _check_fingerprint_step(mesh):
    data, lens = _batch(np.random.RandomState(mesh.size), 256, 65536,
                        [65536, 0, 1, 55, 56, 64])
    d = torch.from_numpy(data).to(mesh.device(0))
    ln = torch.from_numpy(lens).to(mesh.device(0))
    step = make_fingerprint_step(mesh)
    before = (sha1_batch_cuda.launches, minhash_batch_cuda.launches)
    digests, sigs = step(d, ln)
    n = mesh.size
    assert (sha1_batch_cuda.launches - before[0],
            minhash_batch_cuda.launches - before[1]) == (n, n)
    assert np.array_equal(_u32(digests), _u32(sha1_batch_cuda(d, ln)))
    assert np.array_equal(_u32(sigs), _u32(minhash_batch_cuda(d, ln)))


@pytest.mark.gpu
def test_entry_and_dryrun_on_card(cuda_device):
    fn, (chunks, lengths) = entry()
    out = fn(chunks, lengths)
    raw = sha1.digest_bytes(out["sha1"])
    for i, row in enumerate(chunks):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(row.tobytes()).digest()
    plain = minhash.minhash_batch(torch.from_numpy(chunks).to(cuda_device),
                                  torch.from_numpy(lengths).to(cuda_device))
    assert np.array_equal(_u32(out["minhash"]), _u32(plain))
    want = (gear_hashes_np(chunks.reshape(-1)) & 0x1FFF) == 0
    assert np.array_equal(out["cut_candidates"].cpu().numpy(), want)
    dryrun_multichip(8, devices=[cuda_device] * 8)


# -- the gear CDC and index-query kernels against their plain twins ----------

@pytest.mark.gpu
@pytest.mark.parametrize("size,n,bits", [
    (4096, 4096, 13), (4096, 3001, 6), ((1 << 20) + 4096, (1 << 20) - 17, 13),
    (1 << 26, 1 << 26, 13), (70000, 65537, 0)])
def test_gear_kernel_matches_plain_twin(cuda_device, size, n, bits):
    data = np.random.RandomState(size % 1000 + bits).randint(
        0, 256, size, dtype=np.uint8)
    buf = torch.from_numpy(data).to(cuda_device)
    host = gear_candidates_np(data[:n], bits)
    for k in (max(size >> max(bits - 2, 0), 256), 3, len(host) + 7):
        before = gear_candidates_cuda.launches
        out = gear_candidates_cuda(buf, n, bits, k)
        torch.cuda.synchronize()
        assert gear_candidates_cuda.launches == before + 1
        assert torch.equal(out, gear_candidates(buf, n, bits, k))
        got = out.cpu().numpy()
        pos = got[:k]
        assert got[k] == len(host)
        assert np.array_equal(pos[:len(host)], host[:k])
        assert (pos[len(host):] == size).all()


@pytest.mark.gpu
def test_overflow_recovers_through_the_kernel(cuda_device):
    x, y = dense_pair(13)
    data = np.random.RandomState(21).randint(0, 256, 4 << 20, dtype=np.uint8)
    data[1 << 20:(1 << 20) + (64 << 10)] = np.tile(np.array([x, y], np.uint8),
                                                   32 << 10)
    data = data.tobytes()
    launches, plain = gear_candidates_cuda.launches, gear_window.cuda_calls
    cuts = chunk_stream(data, device=cuda_device)
    assert cuts == chunk_stream_np(data)
    assert gear_candidates_cuda.launches == launches + 2
    assert gear_window.cuda_calls == plain


@pytest.mark.gpu
@pytest.mark.parametrize("b,length,bits", [(2, 1 << 25, 13), (3, 1000, 4),
                                           (1, 3 * TILE + 5, 13),
                                           (3, 2 * TILE + 16, 13),
                                           (2, 40, 0)])
def test_block_kernel_matches_plain_twin(cuda_device, b, length, bits):
    rng = np.random.RandomState(length % 997)
    streams = torch.from_numpy(rng.randint(0, 256, (b, 2, length),
                                           dtype=np.uint8)).to(cuda_device)
    zeros = torch.zeros((b, HALO), dtype=torch.int64, device=cuda_device)
    halos = (zeros, gear_values(streams[:, 0, -HALO:]) if length >= HALO
             else torch.from_numpy(rng.randint(0, 2**32, (b, HALO),
                                               dtype=np.int64)).to(cuda_device))
    for s, halo in enumerate(halos):
        rows = streams[:, s, :]                      # row stride 2 * length
        before = block_candidates_cuda.launches
        got = block_candidates_cuda(rows, halo, bits)
        torch.cuda.synchronize()
        assert block_candidates_cuda.launches == before + 1
        assert torch.equal(got, block_candidates(gear_values(rows), halo,
                                                 bits))
    if length >= HALO:
        whole = candidate_mask(widen(gear_hashes(streams[0].reshape(-1))),
                               bits)
        assert torch.equal(torch.cat([block_candidates_cuda(
            streams[:1, s, :], halos[s][:1], bits) for s in range(2)], 1)[0],
            whole)


def _planted_at_seams(size: int, bits: int, seed: int) -> tuple:
    """Seeded bytes with candidates planted at ``seam_plants(size)``."""
    data = np.random.RandomState(seed).randint(0, 256, size, dtype=np.uint8)
    planted = seam_plants(size)
    for p in planted:
        plant_candidate(data, p, bits)
    return data, planted


@pytest.mark.gpu
def test_gear_kernel_at_the_tile_and_run_seams(cuda_device):
    bits = 13
    data, planted = _planted_at_seams(5 * TILE + 77, bits, 11)
    host = gear_candidates_np(data, bits)
    assert set(planted) <= set(host.tolist())
    buf = torch.from_numpy(data).to(cuda_device)
    for k in (len(host), len(host) // 2):
        out = gear_candidates_cuda(buf, len(data), bits, k)
        torch.cuda.synchronize()
        assert torch.equal(out, gear_candidates(buf, len(data), bits, k))
        got = out.cpu().numpy()
        assert got[k] == len(host) and np.array_equal(got[:k], host[:k])


@pytest.mark.gpu
@pytest.mark.parametrize("more", [True, False])
def test_gear_kernel_with_more_and_fewer_tiles_than_blocks(cuda_device,
                                                           more):
    # The persistent grid has at most two blocks an SM: a block takes over
    # 100 KiB of shared memory (csrc/gear_cdc.cu).  One tile is fewer
    # than any grid.
    blocks = 2 * torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    size = (3 * blocks + 1) * TILE + 4321 if more else 3 * 1024 + 7
    assert (-(-size // TILE) > blocks) if more else size < TILE
    data = np.random.RandomState(size % 1009).randint(0, 256, size,
                                                      dtype=np.uint8)
    host = gear_candidates_np(data, 13)
    buf = torch.from_numpy(data).to(cuda_device)
    for n in (size, size - 1000):
        want = host[host < n]
        for k in (max(size >> 11, 256), len(want) // 3):
            out = gear_candidates_cuda(buf, n, 13, k)
            torch.cuda.synchronize()
            assert torch.equal(out, gear_candidates(buf, n, 13, k))
            got = out.cpu().numpy()
            assert got[k] == len(want)
            assert np.array_equal(got[:min(k, len(want))], want[:k])
            assert (got[len(want):k] == size).all()


@pytest.mark.gpu
@pytest.mark.parametrize("size", [4 << 20, 64 << 20])
def test_gear_kernel_repeats_bit_for_bit(cuda_device, size):
    # 50 launches on a buffer with a dense run (thousands of candidates a
    # tile) and the seams planted: the look-back gives one answer.  At
    # 4 MB a block takes one tile; the 64 MB segment has more tiles than
    # the grid has blocks, so a block takes a span of several and looks
    # back over up to hundreds of spans.
    bits = 13
    data = np.random.RandomState(23).randint(0, 256, size, dtype=np.uint8)
    for p in wide_seam_plants(size, bits):
        plant_wide(data, p, bits)
    x, y = dense_pair(bits)
    data[1 << 20:(1 << 20) + (64 << 10)] = np.tile(
        np.array([x, y], np.uint8), 32 << 10)
    buf = torch.from_numpy(data).to(cuda_device)
    host = gear_candidates_np(data, bits)
    for k in (len(host), len(host) // 2):
        first = gear_candidates_cuda(buf, len(data), bits, k)
        assert np.array_equal(first.cpu().numpy()[:-1], host[:k])
        for _ in range(50):
            assert torch.equal(gear_candidates_cuda(buf, len(data), bits, k),
                               first)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [17, 18, 32])
def test_both_forms_at_wide_avg_bits(cuda_device, bits):
    # Past 17 bits a thread rolls 32 bytes before its run, not 16: plant
    # candidates whose windows cross the run and tile seams and, in the
    # dense form, the second row's start (its window in the halo).
    size = 5 * TILE + 77
    data = np.random.RandomState(bits).randint(0, 256, size, dtype=np.uint8)
    planted = wide_seam_plants(size, bits)
    for p in planted:
        plant_wide(data, p, bits)
    host = gear_candidates_np(data, bits)
    assert set(planted) <= set(host.tolist())
    buf = torch.from_numpy(data).to(cuda_device)
    for k in (len(host) + 3, len(host) // 2):
        out = gear_candidates_cuda(buf, size, bits, k)
        assert torch.equal(out, gear_candidates(buf, size, bits, k))
        got = out.cpu().numpy()
        assert got[k] == len(host)
        assert np.array_equal(got[:min(k, len(host))], host[:k])
    length = 2 * TILE + 16
    rows = buf[:2 * length].view(2, length)
    halo = torch.cat([torch.zeros((1, HALO), dtype=torch.int64,
                                  device=cuda_device),
                      gear_values(rows[:1, -HALO:])])
    mask = block_candidates_cuda(rows, halo, bits)
    assert torch.equal(mask, block_candidates(gear_values(rows), halo, bits))
    assert np.array_equal(np.flatnonzero(mask.reshape(-1).cpu().numpy()),
                          host[host < 2 * length])


@pytest.mark.gpu
def test_block_kernel_at_the_tile_and_run_seams(cuda_device):
    # Two rows of one stream, each a few tiles long, the second after the
    # gear values of the first's last 31 bytes: the whole stream's mask.
    bits = 13
    length = 3 * TILE
    data, _ = _planted_at_seams(2 * length, bits, 31)
    for p in (length - 3, length - 1, length + 1, length + 3,
              length + TILE + 1):
        plant_candidate(data, p, bits)
    stream = torch.from_numpy(data).to(cuda_device)
    rows = stream.view(2, length)
    halo = torch.cat([torch.zeros((1, HALO), dtype=torch.int64,
                                  device=cuda_device),
                      gear_values(rows[:1, -HALO:])])
    got = block_candidates_cuda(rows, halo, bits)
    whole = candidate_mask(widen(gear_hashes(stream)), bits)
    assert torch.equal(got.reshape(-1), whole)
    assert torch.equal(got, block_candidates(gear_values(rows), halo, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,p", [(13, 37, 8), (257, 70, 33), (65, 129, 64),
                                   (100, 0, 64), (1, 1, 1), (64, 64, 48),
                                   (6400, 65536, 64)])
def test_index_kernel_matches_plain_twin(cuda_device, n, m, p):
    rng = np.random.RandomState(n + m + p)
    hi = 3 if n * m < 1 << 20 else 2**32
    words = rng.randint(0, hi, (n + m, p), dtype=np.uint64).astype(np.uint32)
    if m:
        words[:min(n, 5)] = words[n:n + min(n, 5)]    # exact matches
    t = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    sigs, index = t[:n], t[n:]
    before = index_best_cuda.launches
    got = index_best_cuda(sigs, index)
    torch.cuda.synchronize()
    assert index_best_cuda.launches == before + (1 if m else 0)
    assert torch.equal(got, index_best(sigs, index))
    if m:
        assert (got[:min(n, 5)] == 1.0).all()


# The GF(2^8) kernel (csrc/gf_matmul.cu) and the stage-4 kernel
# (csrc/minhash_sig.cu) against their plain twins on the card.

def _gf_check(mat: np.ndarray, shards: torch.Tensor) -> None:
    before = gf_matmul_cuda.launches
    got = gf_matmul_cuda(mat, shards)
    torch.cuda.synchronize()
    assert gf_matmul_cuda.launches == before + (1 if shards.shape[1] else 0)
    assert got.shape == (mat.shape[0], shards.shape[1])
    assert torch.equal(got, rs_code.gf_matmul_torch(mat, shards))
    assert np.array_equal(got.cpu().numpy(),
                          rs_code.gf_matmul_np(mat, shards.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [0, 1, 3, 17, 4097])
@pytest.mark.parametrize("rows,k", [(2, 4), (4, 10), (8, 32), (32, 32),
                                    (40, 7)])
def test_gf_kernel_at_edge_lengths(cuda_device, length, rows, k):
    rng = np.random.default_rng(rows * 1000 + k + length)
    mat = rng.integers(0, 256, (rows, k), dtype=np.uint8)
    shards = torch.from_numpy(rng.integers(0, 256, (k, length),
                                           dtype=np.uint8)).to(cuda_device)
    _gf_check(mat, shards)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k", [(32, 8), (64, 4), (255, 1), (1, 255),
                                    (33, 33)])
def test_gf_kernel_holds_every_byte_value(cuda_device, rows, k):
    # Every coefficient 0..255 appears (0 and 1 included), rows past 32
    # split over blockIdx.y.
    mat = (np.arange(rows * k) % 256).astype(np.uint8).reshape(rows, k)
    rng = np.random.default_rng(rows + k)
    shards = torch.from_numpy(rng.integers(0, 256, (k, 1031),
                                           dtype=np.uint8)).to(cuda_device)
    shards[:, :256] = torch.arange(256, dtype=torch.uint8)
    _gf_check(mat, shards)


@pytest.mark.gpu
def test_gf_kernel_on_views_and_the_rebuild(cuda_device):
    k, m, length = 10, 4, 4099
    rng = np.random.default_rng(9)
    d = torch.from_numpy(rng.integers(0, 256, (2 * k, length),
                                      dtype=np.uint8)).to(cuda_device)
    pm = rs_code.parity_matrix(k, m)
    # A row-offset view, every other row, and column slices whose rows
    # start off a 4-byte boundary: none is copied.
    for view in (d[m:m + k], d[::2], d[:k, 1:], d[m:m + k, 3:4000]):
        _gf_check(pm, view)
    out = torch.zeros((2 * m, length), dtype=torch.uint8, device=cuda_device)
    got = gf_matmul_cuda(pm, d[:k], out[::2])
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out[::2], rs_code.gf_matmul_torch(pm, d[:k]))
    assert not out[1::2].any()
    parity = rs_code.rs_encode(d[:k], m)
    survivors = torch.cat([d[m:k], parity])
    back = rs_code.rs_reconstruct(survivors, list(range(m, k + m)), k, m)
    assert torch.equal(back, d[:k])


def _survivors(dev, rng, n: int, length: int = 4096) -> torch.Tensor:
    """Real survivor vectors of n random rows (the sketch kernel's z;
    short rows among them), rows 0 and 1 all EMPTY and row 5 with one
    survivor."""
    data, lens = _batch(rng, n, length, [0, 0, 1, 4, length])
    z = survivor_segmin_cuda(torch.from_numpy(data).to(dev),
                             torch.from_numpy(lens).to(dev)).view(torch.int32)
    z[:2].fill_(-1)
    z[5].fill_(-1)
    z[5, 17] = 123456789
    return z


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 7, 31, 32, 33, 64, 100, 128, 300])
def test_stage4_kernel_matches_plain_twin(cuda_device, p):
    rng = np.random.RandomState(p)
    z = _survivors(cuda_device, rng, 517)
    words = minhash.perm_words(p, cuda_device)
    before = signature_tiles_cuda.launches
    got = signature_tiles_cuda(z, words)
    torch.cuda.synchronize()
    assert signature_tiles_cuda.launches == before + 1
    want = minhash.signature_tiles(z, p, minhash.perms_from_words(words))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got.view(torch.int32)[:2] == -1).all()   # all-EMPTY rows


@pytest.mark.gpu
def test_stage4_kernel_on_views_and_a_rank_slice(cuda_device):
    rng = np.random.RandomState(3)
    z = _survivors(cuda_device, rng, 300)
    words = minhash.perm_words(64, cuda_device)
    out = torch.full((150, 40), 7, dtype=torch.int32, device=cuda_device)
    for t in range(2):
        rank = words[:, 32 * t:32 * (t + 1)].contiguous()
        got = signature_tiles_cuda(z[::2], rank, out[:, 4:36])
        want = minhash.signature_tiles(z[::2], 32,
                                       minhash.perms_from_words(rank))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (out[:, :4] == 7).all() and (out[:, 36:] == 7).all()
    assert signature_tiles_cuda(z[:0], words).shape == (0, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("perms", [32, 128])
def test_ingest_and_fingerprint_steps_at_other_counts(cuda_device, perms):
    rng = np.random.RandomState(perms)
    streams = torch.from_numpy(
        rng.randint(0, 256, (2, 1 << 16), dtype=np.uint8)).to(cuda_device)
    data, lens = _batch(rng, 64, 2048, [2048, 0, 1, 55])
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    plain = _u32(minhash.minhash_batch(d, ln, perms))
    index = plain[::3].copy()
    mesh = make_mesh(8, devices=[cuda_device] * 8)
    before = signature_tiles_cuda.launches
    _, _, sigs, best = make_ingest_step(mesh, num_perms=perms)(
        streams.view(2, mesh.shape["sp"], -1), d, ln, index)
    torch.cuda.synchronize()
    assert signature_tiles_cuda.launches == before + 8
    assert np.array_equal(_u32(sigs), plain)
    assert (best[::3] == 1.0).all()
    step = make_fingerprint_step(fingerprint_mesh(2, devices=[cuda_device] * 2),
                                 num_perms=perms)
    _, sigs = step(d, ln)
    assert np.array_equal(_u32(sigs), plain)


# The sketch at any shingle width (csrc/minhash_survivor.cu's general
# kernel, both forms), the GF(2^8) kernel at the field's row and shard
# counts, and the stage-4 kernel over more rows than its persistent grid
# has warps and on rows off a 16-byte boundary.

SHINGLES = [1, 2, 3, 4, 6, 8, 13, 32]


@pytest.mark.gpu
@pytest.mark.parametrize("k", SHINGLES)
def test_general_k_kernel_matches_plain_twin(cuda_device, k):
    seg, offsets, lens = shingle_segment(np.random.default_rng(100 + k), k)
    d_seg, d_off, d_len, d_ord = _on_card(cuda_device, seg, offsets, lens)
    before = survivor_ragged_cuda.launches
    got = survivor_ragged_cuda(d_seg, d_off, d_len, k, order=d_ord)
    unordered = survivor_ragged_cuda(d_seg, d_off, d_len, k)
    torch.cuda.synchronize()
    assert survivor_ragged_cuda.launches == before + 2
    want = minhash.survivor_ragged(d_seg[:len(seg)], d_off, d_len, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(unordered.view(torch.int32), want.view(torch.int32))
    # The padded entry over the same kernel.
    rng = np.random.RandomState(k)
    data, ln = _batch(rng, 64, 2048, [0, 1, max(k - 1, 0), k, k + 1, 2048])
    d = torch.from_numpy(data).to(cuda_device)
    dl = torch.from_numpy(ln).to(cuda_device)
    before = survivor_segmin_cuda.launches
    got = survivor_segmin_cuda(d, dl, k)
    torch.cuda.synchronize()
    assert survivor_segmin_cuda.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       minhash.survivor_segmin(d, dl, k).view(torch.int32))


def _check_fused_general(dev, seg, offsets, lens, k):
    """The general kernel's fused form on one segment, with and without
    the longest-first order: signatures alone, and signatures and z from
    one launch, against the plain twin."""
    d_seg, d_off, d_len, d_ord = _on_card(dev, seg, offsets, lens)
    want_sig, want_z = minhash.sketch_ragged(d_seg[:len(seg)], d_off, d_len,
                                             64, k, row_tile=4096,
                                             with_z=True)
    words = minhash.perm_words(64, dev)
    before = sketch_ragged_cuda.launches
    for order in (d_ord, None):
        alone = sketch_ragged_cuda(d_seg, d_off, d_len, words, order, k=k)
        sig, z = sketch_ragged_cuda(d_seg, d_off, d_len, None, order, k=k,
                                    with_z=True)
        for got, want in ((alone, want_sig), (sig, want_sig), (z, want_z)):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()
    assert sketch_ragged_cuda.launches == before + 4
    return want_z


@pytest.mark.gpu
@pytest.mark.parametrize("k", SHINGLES)
def test_fused_general_kernel_matches_plain_twin(cuda_device, k):
    # Lengths 0, 1, k - 1, k, k + 1 and a few hundred at every start
    # offset mod 4 between non-zero bytes, and a chunk of three passes and
    # a tail; then the padded entry at 64 permutations.
    seg, offsets, lens = shingle_segment(np.random.default_rng(200 + k), k)
    z = _check_fused_general(cuda_device, seg, offsets, lens, k)
    assert (z.view(torch.int32) != -1).any()
    rng = np.random.RandomState(200 + k)
    data, ln = _batch(rng, 64, 2048, [0, 1, max(k - 1, 0), k, k + 1, 2048])
    d = torch.from_numpy(data).to(cuda_device)
    dl = torch.from_numpy(ln).to(cuda_device)
    before = minhash_batch_cuda.launches
    got = minhash_batch_cuda(d, dl, 64, k)
    torch.cuda.synchronize()
    assert minhash_batch_cuda.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       minhash.minhash_batch(d, dl, 64, k).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4090, 4111, 5000])
def test_fused_general_kernel_past_the_leading_view(cuda_device, k):
    # Windows wider than a pass's leading view: a run's first hash reads
    # bytes from the trailing view and from the segment.
    rng = np.random.default_rng(k)
    lens = [0, 1, k - 1, k, k + 1, k + 4096 + 37, 3 * k]
    seg, offsets = bytearray(), []
    for i, n in enumerate(lens):
        seg += rng.integers(1, 256, 1 + (i - len(seg) - 1) % 4,
                            dtype=np.uint8).tobytes()
        offsets.append(len(seg))
        seg += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    _check_fused_general(cuda_device, bytes(seg), offsets, lens, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 8])
def test_general_k_kernel_on_a_64mb_segment(cuda_device, k):
    rng = np.random.RandomState(k)
    seg = rng.randint(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    cuts = chunk_stream_np(seg)
    offsets = [0] + cuts[:-1]
    lens = [b - a for a, b in zip(offsets, cuts)]
    d_seg, d_off, d_len, d_ord = _on_card(cuda_device, seg, offsets, lens)
    got = survivor_ragged_cuda(d_seg, d_off, d_len, k, order=d_ord)
    want = minhash.survivor_ragged(d_seg[:len(seg)], d_off, d_len, k,
                                   row_tile=4096)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got.view(torch.int32) != -1).sum() > 0
    z = _check_fused_general(cuda_device, seg, offsets, lens, k)
    assert torch.equal(z.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shingle,perms", [(4, 64), (8, 32)])
def test_engine_at_other_shingles_on_card_matches_cpu(cuda_device, shingle,
                                                      perms):
    # 64 permutations: one fused launch at any width; another count:
    # stages 1-3, then the stage-4 kernel.
    rng = np.random.RandomState(shingle)
    data = rng.randint(0, 256, size=300_000, dtype=np.uint8).tobytes()
    cfg = DedupConfig(min_size=64, avg_bits=8, max_size=1024, row_tile=32,
                      num_perms=perms, shingle=shingle)
    wrappers = (sketch_ragged_cuda, survivor_ragged_cuda,
                signature_tiles_cuda)
    before = [f.launches for f in wrappers]
    calls = (minhash.survivor_ragged.cuda_calls,
             minhash.survivor_segmin.cuda_calls,
             minhash.signature_tiles.cuda_calls)
    got = DedupEngine(cfg, device=cuda_device).fingerprint(data)
    torch.cuda.synchronize()
    launched = [f.launches - b for f, b in zip(wrappers, before)]
    assert launched == ([1, 0, 0] if perms == 64 else [0, 1, 1])
    assert (minhash.survivor_ragged.cuda_calls,
            minhash.survivor_segmin.cuda_calls,
            minhash.signature_tiles.cuda_calls) == calls
    ref = DedupEngine(cfg, device="cpu").fingerprint(data)
    assert got[0] == ref[0]
    assert np.array_equal(got[1], ref[1])
    assert np.array_equal(got[2], ref[2])


@pytest.mark.gpu
def test_ingest_step_at_shingle_4_on_card(cuda_device):
    # One rank holds all 64 permutations: the fused launch.  The 8-rank
    # mesh's tp = 2 ranks: stages 1-3, then stage 4 on their slices.
    rng = np.random.RandomState(4)
    streams = torch.from_numpy(
        rng.randint(0, 256, (2, 1 << 16), dtype=np.uint8)).to(cuda_device)
    data, lens = _batch(rng, 64, 2048, [2048, 0, 1, 3, 4, 5])
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lens).to(cuda_device)
    plain = _u32(minhash.minhash_batch(d, ln, 64, 4))
    index = plain[::3].copy()
    wrappers = (minhash_batch_cuda, survivor_segmin_cuda,
                signature_tiles_cuda)
    for n, want in ((1, [1, 0, 0]), (8, [0, 8, 8])):
        mesh = make_mesh(n, devices=[cuda_device] * n)
        before = [f.launches for f in wrappers]
        _, _, sigs, best = make_ingest_step(mesh, shingle=4)(
            streams.view(2, mesh.shape["sp"], -1), d, ln, index)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(wrappers, before)] == want
        assert np.array_equal(_u32(sigs), plain)
        assert (best[::3] == 1.0).all()
    step = make_fingerprint_step(fingerprint_mesh(2, devices=[cuda_device] * 2),
                                 shingle=4)
    before = minhash_batch_cuda.launches
    _, sigs = step(d, ln)
    torch.cuda.synchronize()
    assert minhash_batch_cuda.launches == before + 2
    assert np.array_equal(_u32(sigs), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 17, 255])
@pytest.mark.parametrize("k", [1, 17, 255])
def test_gf_kernel_at_the_fields_row_and_shard_counts(cuda_device, rows, k):
    rng = np.random.default_rng(rows * 256 + k)
    mat = rng.integers(0, 256, (rows, k), dtype=np.uint8)
    length = 4096 + 16 * 5 + 7          # a second tile and a byte tail
    shards = torch.from_numpy(rng.integers(0, 256, (k, length),
                                           dtype=np.uint8)).to(cuda_device)
    _gf_check(mat, shards)
    _gf_check(mat, shards[:, 5:])       # rows off a 16-byte boundary


@pytest.mark.gpu
@pytest.mark.parametrize("p", [32, 300])
def test_stage4_kernel_on_many_and_unaligned_rows(cuda_device, p):
    # More rows than the persistent grid has warps (each warp signs
    # several, the next loaded while the current is signed), on rows 1028
    # words apart and on the same rows from a base off 16 bytes (4-byte
    # loads).
    rng = np.random.RandomState(p)
    n = 20_000
    zs = rng.randint(0, 2**32, (n, 1028), dtype=np.uint64).astype(np.uint32)
    zs[rng.random_sample(zs.shape) < 0.96] = 0xFFFFFFFF
    zs[:3] = 0xFFFFFFFF
    z_all = torch.from_numpy(zs.view(np.int32)).to(cuda_device)
    words = minhash.perm_words(p, cuda_device)
    for z in (z_all[:, :1024], z_all[:, 1:1025]):
        got = signature_tiles_cuda(z, words)
        want = minhash.signature_tiles(z, p, minhash.perms_from_words(words),
                                       256)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got.view(torch.int32)[:3] == -1).all()
