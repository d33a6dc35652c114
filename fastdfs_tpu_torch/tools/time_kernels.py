"""Time the port's hand kernels of one or more checkouts on one card,
each checkout in a process of its own, in the order given:

    python3 fastdfs_tpu_torch/tools/time_kernels.py [--only NAME,...] ROOT [ROOT ...]

ROOT is a checkout's top directory: its ``fastdfs_tpu_torch`` is
imported and builds its kernels there.  Give two checkouts as A B B A to
compare them within one run.  The card's name and power limit come
first, then one JSON line a checkout, with an entry for each case (all,
or those ``--only`` names):

- ``compact``: ``gear_candidates_cuda`` on a seeded 2^26-byte buffer at
  avg_bits 13 with ``chunk_stream``'s k (2^26 >> 11), as the client's
  fingerprint calls it;
- ``dense``: ``block_candidates_cuda`` on two seeded rows of 2^26 bytes
  after zero halos, as the 1-rank ingest step calls it;
- ``sketch``: ``sketch_ragged_cuda`` (the fused k = 5 kernel) on a
  seeded 64 MB segment cut by ``chunk_stream_np``, as the engine calls it;
- ``sketch_k4`` and ``sketch_k8``: ``sketch_ragged_cuda(..., k=4)`` and
  ``k=8`` (the general kernel, stage 4 fused) on the same segment, as the
  engine calls it at ``DedupConfig(shingle=4)`` or ``8``;
- ``sketch_k5``: the general kernel at k = 5 on the same segment, through
  its C entry ``fdfs_sketch_ragged_k`` (the wrappers send k = 5 to the
  k = 5 kernel): the same signatures as ``sketch``;
- ``survivor_k4``: ``survivor_ragged_cuda`` at k = 4 (stages 1-3 alone,
  ``z``) on the same segment;
- ``two_launch_k4``: ``survivor_ragged_cuda`` at k = 4, then
  ``signature_tiles_cuda`` at 64 permutations on its ``z``: the engine's
  path at shingle 4 before the general kernel signed;
- ``gf_rebuild`` and ``gf_encode``: ``gf_matmul_cuda`` at RS(32,8) over
  seeded 2 MiB shards (a 64 MB stripe), the rebuild's 32 x 32 decode
  matrix of the last 32 of 40 shards and the 8 x 32 parity matrix;
- ``stage4``: ``signature_tiles_cuda`` on 3,234 seeded survivor vectors
  with 39 non-EMPTY minima a row on average (a dp rank's share of a
  64 MB stream's chunks at the default geometry) at one tp rank's 32
  permutations.

Each has ``ms``, the CUDA-event median of 20 calls of the wrapper, and
``device_ms``, its device time under torch.profiler over 20 calls: all
that a call puts on the card (kernels, memsets), without the host's
time in the wrapper (null where the profiler, in 5 runs, never showed
half the calls' kernels).  ``check`` (a count or a sum of the output)
tells that the checkouts computed the same function.  A case whose
wrapper a checkout lacks (``sketch_ragged_cuda`` without ``k``) is null
there.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

SEGMENT = 1 << 26
AVG_BITS = 13
CALLS = 20
TRIES = 5
SEED = 20261017
STAGE4_ROWS = 3234
STAGE4_SURVIVOR_SHARE = 39 / 1024
CASES = ("compact", "dense", "sketch", "sketch_k4", "sketch_k8",
         "sketch_k5", "survivor_k4", "two_launch_k4", "gf_rebuild",
         "gf_encode", "stage4")
# A device kernel each case must show (a name the parent's kernels share
# where the case is the parent's too).
KERNEL_NAMES = {"compact": "gear_", "dense": "gear_",
                "sketch": "sketch_ragged_kernel",
                "sketch_k4": "sketch_k_kernel", "sketch_k8": "sketch_k_kernel",
                "sketch_k5": "sketch_k_kernel",
                "survivor_k4": "_k_kernel",
                "two_launch_k4": "minhash_sig_kernel",
                "gf_rebuild": "gf_matmul_kernel",
                "gf_encode": "gf_matmul_kernel",
                "stage4": "minhash_sig_kernel"}


def _device_ms(torch, fn, kernel: str) -> float | None:
    """The mean time of each device kernel or memset of CALLS calls,
    summed (each runs once a call): the profiler drops one of a run's
    device events now and then, and a mean leaves it out.  None where it
    never, in TRIES runs, showed half the calls' kernels whose names hold
    ``kernel``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if any(kernel in ev.key for ev in events) and all(
                2 * ev.count >= CALLS for ev in events if kernel in ev.key):
            return sum(ev.self_device_time_total / ev.count
                       for ev in events) / 1e3
    return None


@functools.lru_cache(maxsize=1)
def _segment(np, torch, dev):
    """The seeded 64 MB segment with its zero slack, cut by
    ``chunk_stream_np``, and its chunk table on the card (made once a
    process)."""
    from fastdfs_tpu_torch.ops import SEGMENT_SLACK
    from fastdfs_tpu_torch.ops.gear_cdc import chunk_stream_np
    data = np.random.default_rng(SEED).integers(0, 256, SEGMENT,
                                                dtype=np.uint8)
    ends = np.asarray(chunk_stream_np(data.tobytes()), np.int64)
    lens = np.diff(ends, prepend=0).astype(np.int32)
    seg = torch.from_numpy(np.concatenate(
        [data, np.zeros(SEGMENT_SLACK, np.uint8)])).to(dev)
    order = np.argsort(-lens, kind="stable").astype(np.int32)
    return (seg, torch.from_numpy(ends - lens).to(dev),
            torch.from_numpy(lens).to(dev), torch.from_numpy(order).to(dev))


def _general_at_5(torch, seg, off, ln, order):
    """The general-width kernel at k = 5, launched through its C entry
    (the wrappers send k = 5 to the k = 5 kernel)."""
    from fastdfs_tpu_torch.ops import _build
    from fastdfs_tpu_torch.ops.minhash import perm_words
    words = perm_words(64, seg.device)
    n = off.shape[0]

    def call():
        sig = torch.empty((n, 64), dtype=torch.int32, device=seg.device)
        rc = _build.library().fdfs_sketch_ragged_k(
            seg.data_ptr(), off.data_ptr(), ln.data_ptr(), order.data_ptr(),
            words.data_ptr(), n, 5, pow(0x01000193, 5, 1 << 32),
            sig.data_ptr(), 64, None,
            torch.cuda.current_stream().cuda_stream)
        _build.check_launch(rc, "sketch_ragged_k")
        return sig
    return call


def _inputs(np, torch, dev, name: str):
    """``(fn, check)``: one call of the case's wrapper and a function of
    its output that two checkouts must agree on; None where the
    checkout's wrapper cannot make the call."""
    rng = np.random.default_rng(SEED)
    if name in ("compact", "dense"):
        from fastdfs_tpu_torch.ops.cuda_gear import (HALO,
                                                     block_candidates_cuda,
                                                     gear_candidates_cuda)
        if name == "compact":
            buf = torch.from_numpy(rng.integers(0, 256, SEGMENT,
                                                dtype=np.uint8)).to(dev)
            k = SEGMENT >> (AVG_BITS - 2)
            return (lambda: gear_candidates_cuda(buf, SEGMENT, AVG_BITS, k),
                    lambda out: int(out[k]))
        rows = torch.from_numpy(rng.integers(0, 256, (2, SEGMENT),
                                             dtype=np.uint8)).to(dev)
        zeros = torch.zeros((2, HALO), dtype=torch.int64, device=dev)
        return (lambda: block_candidates_cuda(rows, zeros, AVG_BITS),
                lambda out: int(out.sum()))
    if name == "sketch" or name[:-1] in ("sketch_k", "survivor_k",
                                         "two_launch_k"):
        import inspect

        from fastdfs_tpu_torch.ops.cuda_minhash import (signature_tiles_cuda,
                                                        sketch_ragged_cuda,
                                                        survivor_ragged_cuda)
        from fastdfs_tpu_torch.ops.minhash import perm_words
        seg, off, ln, order = _segment(np, torch, dev)
        total = (lambda out: int(out.view(torch.int32).to(torch.int64)
                                 .sum()))
        if name == "sketch":
            return (lambda: sketch_ragged_cuda(seg, off, ln, None, order),
                    total)
        k = int(name[-1])
        if name.startswith("survivor"):
            return (lambda: survivor_ragged_cuda(seg, off, ln, k,
                                                 order=order), total)
        if name.startswith("two_launch"):
            words = perm_words(64, dev)
            return (lambda: signature_tiles_cuda(
                survivor_ragged_cuda(seg, off, ln, k, order=order), words),
                total)
        if "k" not in inspect.signature(sketch_ragged_cuda).parameters:
            return None
        if k == 5:
            return _general_at_5(torch, seg, off, ln, order), total
        return (lambda: sketch_ragged_cuda(seg, off, ln, None, order, k=k),
                total)
    if name.startswith("gf_"):
        from fastdfs_tpu_torch.ops import rs_code
        from fastdfs_tpu_torch.ops.cuda_gf import gf_matmul_cuda
        k, m = 32, 8
        mat = (rs_code.decode_matrix(k, m, list(range(m, k + m)))
               if name == "gf_rebuild" else rs_code.parity_matrix(k, m))
        shards = torch.from_numpy(rng.integers(
            0, 256, (k, SEGMENT // k), dtype=np.uint8)).to(dev)
        return (lambda: gf_matmul_cuda(mat, shards),
                lambda out: int(out.to(torch.int64).sum()))
    from fastdfs_tpu_torch.ops import minhash
    from fastdfs_tpu_torch.ops.cuda_minhash import signature_tiles_cuda
    z = rng.integers(0, 2**32, (STAGE4_ROWS, minhash.NUM_SEGMENTS),
                     dtype=np.uint64).astype(np.uint32)
    z[rng.random(z.shape) >= STAGE4_SURVIVOR_SHARE] = minhash.EMPTY
    d_z = torch.from_numpy(z.view(np.int32)).to(dev)
    words = minhash.perm_words(64, dev)[:, :32].contiguous()
    return (lambda: signature_tiles_cuda(d_z, words),
            lambda out: int(out.view(torch.int32).to(torch.int64).sum()))


def time_one(root: str, names: list[str]) -> dict:
    """The named cases of the checkout at ``root``, on the current card."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from fastdfs_tpu_torch.tools.timing import median_ms

    dev = torch.device("cuda")
    out = {"root": root}
    for name in names:
        case = _inputs(np, torch, dev, name)
        if case is None:
            out[name] = None
            continue
        fn, check = case
        out[name] = {"ms": median_ms(fn, CALLS),
                     "device_ms": _device_ms(torch, fn, KERNEL_NAMES[name]),
                     "check": check(fn())}
    return out


def main(argv: list[str]) -> int:
    names = list(CASES)
    if argv[:1] == ["--only"] and len(argv) > 1:
        names = argv[1].split(",")
        argv = argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_one(argv[1], names)), flush=True)
        return 0
    if not argv or any(n not in CASES for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip(), flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--only", ",".join(names), "--one", root],
                             timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
