"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs a CUDA card and skips without one.  This file imports nothing of
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
from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine
from fastdfs_tpu_torch.ops import SEGMENT_SLACK, minhash, rs_code, sha1
from fastdfs_tpu_torch.ops.cuda_minhash import (minhash_batch_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda, sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import chunk_stream_np
from fastdfs_tpu_torch.ops.streaming import stream_batches


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
    z = survivor_ragged_cuda(d_seg, d_off, d_len, d_ord)
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
