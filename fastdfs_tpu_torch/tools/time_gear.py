"""Time the gear CDC kernel's two forms of one or more checkouts on one
card, each checkout in a process of its own, in the order given:

    python3 fastdfs_tpu_torch/tools/time_gear.py ROOT [ROOT ...]

ROOT is a checkout's top directory: its ``fastdfs_tpu_torch`` is
imported and builds its kernels there.  Give two checkouts as A B B A to
compare them within one run.  The card's name and power limit come
first, then one JSON line a checkout:

- ``compact``: ``gear_candidates_cuda`` on a seeded 2^26-byte buffer at
  avg_bits 13 with ``chunk_stream``'s k (2^26 >> 11), as the client's
  fingerprint calls it;
- ``dense``: ``block_candidates_cuda`` on two seeded rows of 2^26 bytes
  after zero halos, as the 1-rank ingest step calls it.

Each has ``ms``, the CUDA-event median of 20 calls of the wrapper, and
``device_ms``, its device time under torch.profiler over 20 calls: all
that a call puts on the card (kernels, memsets), without the host's
time in the wrapper (null where the profiler, in 5 runs, never showed
half the calls' gear kernels).  ``candidates`` and ``mask_sum`` tell
that the checkouts computed the same function.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SEGMENT = 1 << 26
AVG_BITS = 13
CALLS = 20
TRIES = 5
SEED = 20261017


def _event_ms(torch, fn) -> float:
    fn()
    times = []
    for _ in range(CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn) -> float | None:
    """The mean time of each device kernel or memset of CALLS calls,
    summed (each runs once a call): the profiler drops one of a run's
    device events now and then, and a mean leaves it out.  None where it
    never, in TRIES runs, showed half the calls' gear kernels."""
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
        if any("gear_" in ev.key for ev in events) and all(
                2 * ev.count >= CALLS for ev in events if "gear_" in ev.key):
            return sum(ev.self_device_time_total / ev.count
                       for ev in events) / 1e3
    return None


def time_one(root: str) -> dict:
    """The two forms of the checkout at ``root``, on the current card."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from fastdfs_tpu_torch.ops.cuda_gear import (HALO, block_candidates_cuda,
                                                 gear_candidates_cuda)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    buf = torch.from_numpy(rng.integers(0, 256, SEGMENT,
                                        dtype=np.uint8)).to(dev)
    rows = torch.from_numpy(rng.integers(0, 256, (2, SEGMENT),
                                         dtype=np.uint8)).to(dev)
    zeros = torch.zeros((2, HALO), dtype=torch.int64, device=dev)
    k = SEGMENT >> (AVG_BITS - 2)

    def compact():
        return gear_candidates_cuda(buf, SEGMENT, AVG_BITS, k)

    def dense():
        return block_candidates_cuda(rows, zeros, AVG_BITS)

    return {"root": root,
            "compact": {"ms": _event_ms(torch, compact),
                        "device_ms": _device_ms(torch, compact),
                        "candidates": int(compact()[k])},
            "dense": {"ms": _event_ms(torch, dense),
                      "device_ms": _device_ms(torch, dense),
                      "mask_sum": int(dense().sum())}}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip(), flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
