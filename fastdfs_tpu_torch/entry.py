"""Entry points of the port: the fingerprint forward step and a mesh dry run.

The counterpart of the JAX package's ``__graft_entry__.py``:

- ``entry(device)`` returns the upload-path fingerprint step (batched
  SHA-1 and MinHash over a chunk batch through the two CUDA kernels, and
  the CDC cut candidates of the concatenated stream through the gear
  kernel's dense form) with example arguments.
- ``dryrun_multichip(n, devices)`` builds an ``n``-rank (dp, sp, tp) mesh
  and runs the whole distributed ingest step once at tiny shapes.
  Without ``devices`` it asks for ``n`` CUDA cards and raises if fewer
  are visible; ``devices=[torch.device("cuda", 0)] * 8`` places eight
  ranks on one card, ``["cpu"] * 8`` on the CPU.

    python -m fastdfs_tpu_torch.entry      # on a CUDA host
"""

from __future__ import annotations

import numpy as np
import torch

from fastdfs_tpu_torch.ops import resolve_device
from fastdfs_tpu_torch.ops.cuda_gear import HALO, block_candidates_cuda
from fastdfs_tpu_torch.ops.cuda_minhash import minhash_batch_cuda
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda
from fastdfs_tpu_torch.ops.gear_cdc import DEFAULT_AVG_BITS
from fastdfs_tpu_torch.parallel import distributed_ingest_step, make_mesh


def entry(device: str | torch.device = "cuda"):
    """``(fingerprint_step, (chunks, lengths))``: the single-device
    fingerprint forward on ``device`` and seeded example arguments."""
    dev = resolve_device(device)

    def fingerprint_step(chunks, lengths) -> dict[str, torch.Tensor]:
        """chunks: uint8 (N, L); lengths: int32 (N,).  Per-chunk SHA-1
        digests and MinHash signatures, and the CDC cut candidates of the
        concatenated stream."""
        chunks = torch.as_tensor(chunks, dtype=torch.uint8).to(dev).contiguous()
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
        halo = torch.zeros((1, HALO), dtype=torch.int64, device=dev)
        cand = block_candidates_cuda(chunks.reshape(1, -1), halo,
                                     DEFAULT_AVG_BITS)[0]
        return {
            "sha1": sha1_batch_cuda(chunks, lengths),
            "minhash": minhash_batch_cuda(chunks, lengths),
            "cut_candidates": cand,
            "n_candidates": cand.sum(dtype=torch.int32),
        }

    rng = np.random.RandomState(0)
    chunks = rng.randint(0, 256, size=(64, 4096), dtype=np.uint8)
    lengths = np.full(64, 4096, dtype=np.int32)
    return fingerprint_step, (chunks, lengths)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the full distributed ingest step over an ``n_devices``-rank
    mesh at tiny shapes and check its output shapes."""
    mesh = make_mesh(n_devices, devices=devices)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    rng = np.random.RandomState(0)
    B, LBLK = 2 * dp, 512          # B streams split into sp blocks each
    N, L, M, PERMS = 8 * dp, 256, 4 * dp, 64
    stream = rng.randint(0, 256, size=(B, sp, LBLK), dtype=np.uint8)
    chunks = rng.randint(0, 256, size=(N, L), dtype=np.uint8)
    lens = np.full(N, L, np.int32)
    index_sigs = rng.randint(0, 2**32, size=(M, PERMS),
                             dtype=np.uint64).astype(np.uint32)

    out = distributed_ingest_step(mesh, stream, chunks, lens, index_sigs)
    got = [tuple(x.cpu().shape) for x in out]
    want = [(B, sp, LBLK), (N, 5), (N, PERMS), (N,)]
    if got != want:
        raise AssertionError(f"ingest step shapes {got}, expected {want}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print({k: tuple(v.shape) for k, v in out.items()})
    n = torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
