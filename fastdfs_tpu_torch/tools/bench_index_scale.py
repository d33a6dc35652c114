"""Scale proof for the port's columnar ``ExactDigestIndex``.

The index the sidecar consults on every ``commitchunks``, measured at N
synthetic chunks (default 10M, one node's steady state of config 5's
nominal corpus): RAM per entry, insert and lookup rates, merge pauses,
snapshot size and save and load times.  Pure host work: no daemon, no
kernel and no tensor; the artifact names the card of the host it ran
on (null without one).

Run from the repository root:

    python -m fastdfs_tpu_torch.tools.bench_index_scale [--n 10000000]
        [--out FILE]

It writes ``bench_torch_out/index_scale.json`` by default.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from fastdfs_tpu_torch.dedup.index import ExactDigestIndex
from fastdfs_tpu_torch.tools.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "bench_torch_out", "index_scale.json")
SEED = 42
INSERT_BATCH = 100_000   # inserts timed together for the longest pause
LOOKUPS = 1_000_000      # half of them batched hits
MISSES = 1000            # scalar lookups of absent digests
REMOVE_EVERY = 1000      # every 1000th digest is removed


def rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def digests(n: int, rng: np.random.RandomState) -> np.ndarray:
    """``n`` uniform random 20-byte digests (the key distribution of real
    SHA-1 output) as one ``S20`` array, drawn from ``rng`` first."""
    return rng.randint(0, 256, size=(n, 20), dtype=np.uint8).view(
        "S20").ravel()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="ExactDigestIndex at scale, on the port")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    n = args.n
    rng = np.random.RandomState(SEED)
    # Drawn in one array so the generator's cost and RAM stay out of the
    # index's measurements.
    keys = digests(n, rng)

    idx = ExactDigestIndex()
    rss0 = rss_mb()

    # Inserts: every digest new, carriers cycling over 1000 file ids.
    t0 = time.perf_counter()
    max_pause = 0.0
    for start in range(0, n, INSERT_BATCH):
        t_b = time.perf_counter()
        for i in range(start, min(start + INSERT_BATCH, n)):
            idx.insert(bytes(keys[i]), [f"f{i % 1000}", i])
        max_pause = max(max_pause, time.perf_counter() - t_b)
    insert_s = time.perf_counter() - t0
    rss_after_insert = rss_mb()

    # Batched lookups (the engine's judge path), then scalar misses.
    probe_hit = [bytes(keys[i]) for i in rng.randint(0, n, LOOKUPS // 2)]
    probe_miss = [bytes(rng.randint(0, 256, 20, dtype=np.uint8))
                  for _ in range(MISSES)]
    t0 = time.perf_counter()
    got = idx.lookup_batch(probe_hit)
    lookup_batch_s = time.perf_counter() - t0
    if any(r is None for r in got):
        raise RuntimeError("a batched lookup missed an inserted digest")
    t0 = time.perf_counter()
    for d in probe_miss:
        idx.lookup(d)
    lookup_scalar_s = time.perf_counter() - t0

    # Removals, then the merge that compacts them.
    t0 = time.perf_counter()
    for i in range(0, n, REMOVE_EVERY):
        idx.remove(bytes(keys[i]))
    remove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx._merge()
    merge_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "exact")
        t0 = time.perf_counter()
        idx.save(p)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(p + ".npz") / 1e6
        t0 = time.perf_counter()
        idx2 = ExactDigestIndex.load(p)
        load_s = time.perf_counter() - t0
        if len(idx2) != len(idx):
            raise RuntimeError(f"the snapshot reloaded {len(idx2)} entries "
                               f"of {len(idx)}")

    out = {
        "entries": n,
        "card": card_line() if torch.cuda.is_available() else None,
        "insert_seconds": round(insert_s, 2),
        "inserts_per_sec": round(n / insert_s),
        "max_100k_batch_pause_s": round(max_pause, 3),
        "rss_before_mb": round(rss0, 1),
        "rss_after_insert_mb": round(rss_after_insert, 1),
        "index_bytes_per_entry": round(
            (rss_after_insert - rss0) * 1e6 / n, 1),
        "lookup_batch_per_sec": round(len(probe_hit) / lookup_batch_s),
        "lookup_scalar_per_sec": round(len(probe_miss) / lookup_scalar_s),
        "remove_per_sec": round((n // REMOVE_EVERY) / remove_s),
        "final_merge_seconds": round(merge_s, 3),
        "snapshot_mb": round(size_mb, 1),
        "snapshot_save_seconds": round(save_s, 2),
        "snapshot_load_seconds": round(load_s, 2),
        "note": "synthetic uniform 20B digests; carriers interned over "
                "1000 file ids; rss delta includes the generator-side "
                "probe lists",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
