"""How fast the host copies a segment into pinned staging, and how that
scales with threads and with concurrent callers.

    python -m fastdfs_tpu_torch.tools.stage_copy_rate [--mib 64] [--reps 24]
        [--threads 1,2,4,8] [--callers 1,2,4] [--out FILE]

Prints one JSON object (and writes it to ``--out``): the host's CPU
count, the CPUs this process may run on, and for each number of threads
and of concurrent callers the median and p90 milliseconds of a call,
which copies one segment from pageable memory into the caller's own
pinned buffer split over that many threads, and the rate of all callers
together.  The sources are a pool of distinct segments, eight per
caller, so that no copy reads a segment the cache still holds.

With a CUDA card it adds the engine's own copy, ``dedup.stage_copy.copy``
over the kernel library's C++ threads (``route``), at each number of
callers, alone and beside a thread busy in Python, as another stream's
unpacking is; and, each once, the two other ways to move the segment to
the card: ``.to`` straight from the pageable source, and slicing the
copy so that each slice uploads as soon as it lands; and ``.to`` from
pinned memory for comparison.  Without a card these read null, and the
buffers are pageable.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import threading
import time
import warnings

import numpy as np
import torch

from fastdfs_tpu_torch.dedup import stage_copy

POOL_PER_CALLER = 8


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def card_info() -> dict | None:
    if not torch.cuda.is_available():
        return None
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        info["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def sources(n_bytes: int, count: int, seed: int = 21) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.frombuffer(rng.integers(0, 256, n_bytes, np.uint8).tobytes(),
                          np.uint8) for _ in range(count)]


def staging(n_bytes: int) -> np.ndarray:
    return torch.empty(n_bytes, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available()).numpy()


def summary(ms: list[float], callers: int, n_bytes: int,
            wall_s: float) -> dict:
    ms = np.asarray(ms)
    return {"call_p50_ms": float(np.median(ms)),
            "call_p90_ms": float(np.percentile(ms, 90)),
            "GBps_all_callers": len(ms) * n_bytes / wall_s / 1e9}


def run_callers(callers: int, body, reps: int) -> tuple[list[float], float]:
    """``callers`` threads each run ``body(caller, rep)`` ``reps`` times,
    started together; the milliseconds of every call and the wall time."""
    ms: list[float] = []
    lock = threading.Lock()
    start = threading.Barrier(callers + 1)

    def loop(c):
        mine = []
        start.wait()
        for r in range(reps):
            t = time.perf_counter()
            body(c, r)
            mine.append((time.perf_counter() - t) * 1e3)
        with lock:
            ms.extend(mine)

    threads = [threading.Thread(target=loop, args=(c,)) for c in range(callers)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return ms, time.perf_counter() - t0


def split_copy(srcs, dsts, threads: int, callers: int, reps: int) -> dict:
    """Each caller copies with ``threads`` threads of its own (itself and
    ``threads - 1`` helpers), one equal slice each."""
    n = len(dsts[0])
    bounds = np.linspace(0, n, threads + 1).astype(np.int64) // 64 * 64
    bounds[-1] = n
    stop = False
    gates = [(threading.Barrier(threads), threading.Barrier(threads))
             for _ in range(callers)]
    which = [0] * callers

    def part(c, j):
        a, b = bounds[j], bounds[j + 1]
        dsts[c][a:b] = srcs[which[c]][a:b]

    def helper(c, j):
        go, done = gates[c]
        while True:
            go.wait()
            if stop:
                return
            part(c, j)
            done.wait()

    helpers = [threading.Thread(target=helper, args=(c, j), daemon=True)
               for c in range(callers) for j in range(1, threads)]
    for t in helpers:
        t.start()

    def body(c, r):
        which[c] = c * POOL_PER_CALLER + r % POOL_PER_CALLER
        go, done = gates[c]
        go.wait()
        part(c, 0)
        done.wait()

    ms, wall = run_callers(callers, body, reps)
    stop = True
    for go, _ in gates:
        if threads > 1:
            go.wait()
    for t in helpers:
        t.join(10)
    return summary(ms, callers, n, wall)


def busy_python(stop: threading.Event) -> None:
    """Python work that holds the interpreter lock, as unpacking a
    segment's ~9,000 spans does."""
    a = np.arange(9000, dtype=np.int64)
    while not stop.is_set():
        list(zip(a.tolist(), a.tolist()))


def route(srcs, dsts, callers: int, reps: int, busy: bool, native) -> dict:
    counts = [0, 0]
    lock = threading.Lock()

    def body(c, r):
        slices, pooled = stage_copy.copy(
            dsts[c], srcs[c * POOL_PER_CALLER + r % POOL_PER_CALLER], native)
        with lock:
            counts[0] += slices
            counts[1] += pooled

    stop = threading.Event()
    spinner = threading.Thread(target=busy_python, args=(stop,))
    if busy:
        spinner.start()
    try:
        ms, wall = run_callers(callers, body, reps)
    finally:
        stop.set()
        if busy:
            spinner.join(10)
    out = summary(ms, callers, len(dsts[0]), wall)
    out.update(slices_a_call=counts[0] / len(ms),
               pool_slices_a_call=counts[1] / len(ms))
    return out


def routes(srcs, dsts, args, native) -> dict:
    return {f"callers{c}{'_busy' if busy else ''}":
            route(srcs, dsts, c, args.reps, busy, native)
            for busy in (False, True) for c in args.callers}


def device_routes(srcs, n_bytes: int, reps: int) -> dict:
    """The card's side, one caller: ``.to`` from pinned memory, ``.to``
    straight from the pageable source, and the copy sliced with each
    slice uploaded as it lands (4 and 8 MiB slices)."""
    dev = torch.device("cuda", 0)
    pin = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    pin_np = pin.numpy()
    out_dev = torch.empty(n_bytes, dtype=torch.uint8, device=dev)

    def timed(body):
        body(0)
        torch.cuda.synchronize(dev)
        ms = []
        t0 = time.perf_counter()
        for r in range(reps):
            t = time.perf_counter()
            body(r)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t) * 1e3)
        return summary(ms, 1, n_bytes, time.perf_counter() - t0)

    def pinned_to(r):
        out_dev.copy_(pin, non_blocking=True)

    def pageable_to(r):
        with warnings.catch_warnings():   # the source is read-only bytes
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(srcs[r % len(srcs)])
        out_dev.copy_(src, non_blocking=True)

    def sliced_upload(slice_bytes):
        def body(r):
            src = srcs[r % len(srcs)]
            for a in range(0, n_bytes, slice_bytes):
                b = min(a + slice_bytes, n_bytes)
                pin_np[a:b] = src[a:b]
                out_dev[a:b].copy_(pin[a:b], non_blocking=True)
        return body

    return {"pinned_to": timed(pinned_to),
            "pageable_to": timed(pageable_to),
            "sliced_upload_4MiB": timed(sliced_upload(4 << 20)),
            "sliced_upload_8MiB": timed(sliced_upload(8 << 20))}


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=24)
    ap.add_argument("--threads", type=ints, default=[1, 2, 4, 8])
    ap.add_argument("--callers", type=ints, default=[1, 2, 4])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    n = args.mib << 20
    most = max(args.callers)
    srcs = sources(n, most * POOL_PER_CALLER)
    dsts = [staging(n) for _ in range(most)]
    for d in dsts:
        d[:] = 0                      # fault the pages in before timing
    result = {
        "host": {"cpu_count": os.cpu_count(),
                 "affinity": sorted(os.sched_getaffinity(0)),
                 "cpu_model": cpu_model(), "python": platform.python_version(),
                 "numpy": np.__version__, "torch": torch.__version__},
        "card": card_info(),
        "segment_bytes": n, "reps": args.reps,
        "pinned": torch.cuda.is_available(),
        "split_copy": {f"threads{t}_callers{c}":
                       split_copy(srcs, dsts, t, c, args.reps)
                       for c in args.callers for t in args.threads},
        "route": (routes(srcs, dsts, args,
                         stage_copy.native_copy(torch.device("cuda")))
                  if torch.cuda.is_available() else None),
        "route_params": {"slice_min": stage_copy._SLICE_MIN,
                         "slice_bytes": stage_copy.slice_bytes(n),
                         "copiers": stage_copy._copiers()},
        "device": (device_routes(srcs[:POOL_PER_CALLER], n, args.reps)
                   if torch.cuda.is_available() else None),
    }
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
