"""Fingerprint-pipeline profile on the card: where does the ingest time go?

    python -m fastdfs_tpu_torch.tools.profile_fingerprint [--trace DIR]

The counterpart of the JAX package's ``tools/profile_fingerprint.py``.
Times each stage of the padded fingerprint path in isolation over a
seeded ``(2048, 65536)`` batch of full 64 KiB rows on CUDA card 0 and
prints one JSON object per stage, then a summary with the card's name
and power limit:

- ``host_to_device``: the batch from pinned host memory to the card;
- ``sha1_kernel`` / ``sketch_kernel``: ``sha1_batch_cuda`` and
  ``minhash_batch_cuda`` (SHA-1 and the fused MinHash sketch);
- ``both_kernels``: the two back to back;
- ``sha1_plain_twin`` / ``minhash_plain_twin``: the plain PyTorch twins
  on the card (one call each: they take seconds);
- ``fingerprint_step_1`` / ``fingerprint_step_all``:
  ``parallel.make_fingerprint_step`` over one card and over every
  visible card.

Kernel stages are CUDA-event medians of 6 calls after a warm-up call.
``--trace DIR`` also writes a ``torch.profiler`` Chrome trace of four
rounds of both kernels to ``DIR/fingerprint_trace.json``.  Without a
CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROWS, WIDTH = 2048, 65536
ITERS = 6


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="",
                    help="also write a torch.profiler Chrome trace of four "
                         "rounds of both kernels into this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fingerprint: no CUDA device is visible",
              file=sys.stderr)
        return 2

    from fastdfs_tpu_torch.ops import minhash, sha1
    from fastdfs_tpu_torch.ops.cuda_minhash import minhash_batch_cuda
    from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda
    from fastdfs_tpu_torch.parallel import (fingerprint_mesh,
                                            make_fingerprint_step)
    from fastdfs_tpu_torch.tools.timing import card_line, median_ms, once_ms

    dev = torch.device("cuda", 0)
    card = card_line()
    total = ROWS * WIDTH
    rng = np.random.RandomState(0)
    host = torch.from_numpy(rng.randint(0, 256, size=(ROWS, WIDTH),
                                        dtype=np.uint8)).pin_memory()
    dc = host.to(dev)
    dl = torch.full((ROWS,), WIDTH, dtype=torch.int32, device=dev)
    step_1 = make_fingerprint_step(fingerprint_mesh(1))
    step_all = make_fingerprint_step(fingerprint_mesh())
    results = {}

    def record(name: str, ms: float, how: str) -> None:
        results[name] = {"ms": ms, "GBps": total / ms / 1e6, "timed": how}
        print(json.dumps({"stage": name, **results[name]}), flush=True)

    def stage(name: str, fn) -> None:
        record(name, median_ms(fn, ITERS), f"median of {ITERS}")

    def plain(name: str, fn) -> None:
        record(name, once_ms(fn)[1], "one call")

    stage("host_to_device", lambda: host.to(dev, non_blocking=True))
    stage("sha1_kernel", lambda: sha1_batch_cuda(dc, dl))
    stage("sketch_kernel", lambda: minhash_batch_cuda(dc, dl))
    stage("both_kernels", lambda: (sha1_batch_cuda(dc, dl),
                                   minhash_batch_cuda(dc, dl)))
    plain("sha1_plain_twin", lambda: sha1.sha1_batch(dc, dl))
    plain("minhash_plain_twin", lambda: minhash.minhash_batch(dc, dl))
    stage("fingerprint_step_1", lambda: step_1(dc, dl))
    stage("fingerprint_step_all", lambda: step_all(dc, dl))

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.trace, exist_ok=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                sha1_batch_cuda(dc, dl)
                minhash_batch_cuda(dc, dl)
            torch.cuda.synchronize()
        path = os.path.join(args.trace, "fingerprint_trace.json")
        prof.export_chrome_trace(path)
        print(json.dumps({"trace": path}))

    print(json.dumps({"total_bytes": total, "card": card,
                      "cards_visible": torch.cuda.device_count(),
                      "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
