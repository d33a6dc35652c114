"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  One process is one run:

1. set-up: the cell's files (``manifest``), the system under test (the
   cell's call's ``make_system``: for ``fingerprint_cuts``, one shared
   ``DedupEngine`` with its kernels loaded from the program's build
   directory inside the checkout, built there on a checkout's first
   run), the pool of items made from the seed by the cell's corpus
   (``corpus``) and prepared by its call (``prepare``: for
   ``fingerprint_cuts``, the daemon's cuts of each segment, ``cdc``), and
   a warm-up call on every stream thread;
2. the window: one thread for each of the deployment's concurrent calls
   (``Cell.streams``), each in a closed loop, makes the cell's call (for
   ``fingerprint_cuts``, ``DedupEngine.fingerprint(data, cuts)``) on the
   one shared system, as the sidecar's connection threads do, each
   taking the next item of a seeded order over the pool, for
   ``--seconds``;
3. the check: the call's plain reference works out every item's answer
   again and ``check.compare`` holds the window's answers to it;
4. the result: the cell's end-to-end metrics (``--trace 0``) or its
   per-layer metrics from a ``torch.profiler`` trace of the window
   (``--trace 1``), each read by its reader in ``metrics/``, as one JSON
   line, last on standard output; the numbers compared and their limits
   are the last lines on standard error.

It exits with a code other than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, where the cell's files or the
program are missing, and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``fastdfs_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_STARTED = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from types import ModuleType  # noqa: E402

import numpy as np  # noqa: E402

from portbench import check, corpus, manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fastdfs_tpu")
# A call joins the comparison with odds 1 in CHECK_ODDS, drawn from the
# seed by its place in the window, up to CHECK_CAP calls kept: a sample
# over the whole of a window of up to CHECK_ODDS * CHECK_CAP calls.
CHECK_ODDS = 32
CHECK_CAP = 512
_DRAW = 1 << 14
# Seconds past the window's close that a call may take to return.
LATE_S = 60.0
# Seconds of closed-loop calls on every stream before the window, so that
# the window starts with the allocators and caches of the steady state.
WARM_S = 1.0
# Seconds a stream may take to reach the end of its warm-up.
BARRIER_S = 600.0


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module loaded where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _STARTED


@dataclass
class Run:
    """What a metric's reader reads."""
    setup_s: float
    pool: list                 # the items the call's ``prepare`` made
    segment: np.ndarray        # pool index of each call that returned
    latency_s: np.ndarray      # each such call's seconds, call to return
    window_s: float            # first call to last return
    bytes_done: int
    dedup: dict
    answers: dict = field(default_factory=dict)   # the call's reference
    trace: object = None       # trace.Trace of a --trace 1 run
    peak: dict | None = None   # roofline.PEAKS entry of the card


def make_pool(cell: manifest.Cell, seed: int, device, log) -> list:
    """The pool: the items made from the seed by the cell's corpus on the
    host's threads, then prepared by the cell's call on ``device``."""
    cfg, traffic = cell.config, cell.traffic
    seg_bytes = int(traffic["segment_bytes"])
    if seg_bytes > int(cfg["dedup_segment_bytes"]):
        raise manifest.ManifestError(
            f"segments of {seg_bytes} bytes exceed the deployment's "
            f"dedup_segment_bytes {cfg['dedup_segment_bytes']}")
    n = int(cfg["corpus_bytes"]) // seg_bytes
    t = time.monotonic()
    made = corpus.Corpus(cfg["corpus"], seg_bytes, n, seed, cell.corpus)
    with ThreadPoolExecutor(max_workers=min(8, n)) as ex:
        datas = list(ex.map(made.segment, range(n)))
    t_made = time.monotonic() - t
    t = time.monotonic()
    pool = cell.call.prepare(cell, datas, device)
    log(f"set-up: pool of {n} segments of up to {seg_bytes} bytes "
        f"({sum(map(len, datas))} in all) made in {t_made:.3f} s, "
        f"prepared in {time.monotonic() - t:.3f} s")
    return pool


def call_order(seed: int, n: int) -> np.ndarray:
    """The pool indices the window's calls take in turn: seeded
    permutations of the pool, one after another."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 3]))
    return np.concatenate([rng.permutation(n) for _ in range(64)])


def check_draw(seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 4]))
    return rng.integers(0, CHECK_ODDS, _DRAW) == 0


class Window:
    """The streams of one window and what they brought back."""

    def __init__(self, system, call: ModuleType, pool: list,
                 expected: list[tuple], streams: int, seed: int):
        self.system = system
        self.call = call
        self.pool = pool
        self.expected = expected
        self.streams = streams
        self.order = call_order(seed, len(pool))
        self.draw = check_draw(seed)
        self.lock = threading.Lock()
        self.next = 0
        self.first_seen: set[int] = set()
        self.kept: list[check.Kept] = []
        self.records: list[tuple[int, tuple, float, float]] = []
        self.errors: list[str] = []
        self.grown = threading.Barrier(streams, action=self._warm_until)
        self.warm = threading.Barrier(streams + 1)
        self.go = threading.Event()
        self.warm_deadline = 0.0
        self.deadline = 0.0
        self.start = 0.0
        self.warm_s = 0.0

    def _take(self) -> tuple[int, int, bool]:
        with self.lock:
            i = self.next
            self.next += 1
            s = int(self.order[i % len(self.order)])
            keep = (s not in self.first_seen or self.draw[i % _DRAW]) \
                and len(self.kept) < CHECK_CAP
            self.first_seen.add(s)
            return i, s, keep

    def _warm_until(self) -> None:
        self.warm_deadline = time.perf_counter() + WARM_S

    def _call(self, s: int, what: str):
        try:
            return self.call.call(self.system, self.pool[s])
        except Exception as e:  # noqa: BLE001  a wrong answer, counted
            with self.lock:
                self.errors.append(f"{what} on segment {s}: {e!r}")
            return None

    def _stream(self, k: int) -> None:
        # Warm-up: this thread's staging grows to the largest answer of
        # the pool (the most rows: for ``fingerprint_cuts``, the largest
        # chunk table), then every stream runs the closed loop for WARM_S.
        big = max(range(len(self.pool)), key=lambda s: self.expected[s])
        self._call(big, "warm-up")
        self.grown.wait(BARRIER_S)
        s = k
        while time.perf_counter() < self.warm_deadline:
            if self._call(s % len(self.pool), "warm-up") is None:
                break
            s += self.streams
        self.warm.wait(BARRIER_S)
        self.go.wait()
        records = []
        while time.perf_counter() < self.deadline:
            i, s, keep = self._take()
            t0 = time.perf_counter()
            out = self._call(s, f"call {i}")
            if out is None:
                continue
            t1 = time.perf_counter()
            records.append((s, self.call.rows(out), t0, t1))
            if keep:
                with self.lock:
                    self.kept.append(check.Kept(s, out))
        with self.lock:
            self.records.extend(records)

    def run(self, seconds: float, on_start=None) -> float:
        """Warm every stream, then run the window; returns the set-up's
        end on ``time.perf_counter``'s clock."""
        threads = [threading.Thread(target=self._stream, args=(k,),
                                    name=f"stream{k}", daemon=True)
                   for k in range(self.streams)]
        for t in threads:
            t.start()
        t_warm = time.perf_counter()
        self.warm.wait(BARRIER_S)
        self.warm_s = time.perf_counter() - t_warm
        # What set-up made stays: the collector leaves it out of the
        # window's collections.
        gc.collect()
        gc.freeze()
        if on_start is not None:
            on_start()
        self.start = time.perf_counter()
        self.deadline = self.start + seconds
        self.go.set()
        late = self.deadline + LATE_S
        for t in threads:
            t.join(max(0.0, late - time.perf_counter()))
        hung = sum(t.is_alive() for t in threads)
        if hung:
            self.errors.append(f"{hung} calls never returned")
        return self.start

    @property
    def attempted(self) -> int:
        return self.next


def log_stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device, system=None, log=log_stderr) -> tuple[dict, list[str]]:
    """One run of ``cell``: the result's object and the check's lines.
    ``device`` is a ``torch.device``; ``system`` stands in for the call's
    system under test (the control)."""
    import torch

    call = cell.call
    t = time.monotonic()
    on_card = device.type == "cuda"
    log(f"set-up: torch and the card ready {process_seconds():.3f} s "
        f"after the process started")
    if system is None:
        system = call.make_system(cell, device)
    log(f"set-up: the system under test ready in {time.monotonic() - t:.3f} s")
    pool = make_pool(cell, seed, device, log)
    expected = [call.expected_rows(item, cell) for item in pool]
    win = Window(system, call, pool, expected, cell.streams, seed)
    prof = None
    span = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])

        def on_start():
            nonlocal prof, span
            if on_card:
                torch.cuda.synchronize(device)
            prof = profile(activities=acts)
            prof.start()
            span = record_function("portbench.window")
            span.__enter__()
    else:
        on_start = None
    start = win.run(seconds, on_start)
    setup_s = process_seconds() - (time.perf_counter() - start)
    log(f"set-up: {setup_s:.3f} s, the streams' warm-up "
        f"{win.warm_s:.3f} s of it")
    if traced:
        if on_card:
            torch.cuda.synchronize(device)
        span.__exit__(None, None, None)
        prof.stop()
    peak_bytes = (int(torch.cuda.max_memory_allocated(device))
                  if on_card else 0)
    del system
    win.system = None
    kept, records = win.kept, win.records
    ends = [r[3] for r in records]
    window_s = (max(ends) if ends else win.deadline) - start

    # The check, after the window: the reference for every item.
    t = time.monotonic()
    with ThreadPoolExecutor(max_workers=min(8, len(pool))) as ex:
        answers = dict(enumerate(ex.map(
            lambda item: call.reference(item, cell), pool)))
    limits = check.limits(call)
    numbers = check.compare(
        call, kept, [(r[0], r[1]) for r in records], expected, answers,
        len(win.errors), set(range(len(pool))))
    log(f"check: reference over {len(pool)} segments in "
        f"{time.monotonic() - t:.3f} s, {len(kept)} calls compared whole, "
        f"{len(records)} by their rows")
    for e in win.errors[:5]:
        log(f"error: {e}")
    if records:
        sec = np.floor((np.array(ends) - start)).astype(int)
        by = np.bincount(sec, weights=[len(pool[r[0]].data) for r in records])
        log("window GB/s by second: "
            + " ".join(f"{v / 1e9:.2f}" for v in by))

    run = Run(setup_s=setup_s, pool=pool,
              segment=np.array([r[0] for r in records], np.int64),
              latency_s=np.array([r[3] - r[2] for r in records]),
              window_s=window_s,
              bytes_done=sum(len(pool[r[0]].data) for r in records),
              dedup=cell.dedup, answers=answers)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak_bytes}
    result = {"correct": check.holds(numbers, limits),
              "attempted": win.attempted,
              "failed": len(win.errors) + numbers[call.ROWS_WRONG]}
    if traced:
        from portbench import roofline
        from portbench.trace import Trace

        run.trace = Trace.from_profiler(prof)
        run.peak = roofline.PEAKS.get(device_info["kind"])
        metrics = cell.per_layer
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    else:
        metrics = cell.end_to_end
    if hasattr(call, "notes"):
        for line in call.notes(run):
            log(line)
    values = {}
    for m in metrics:
        v = m.reader.read(run)
        if v is not None:
            values[m.name] = {"value": float(v), "unit": m.entry["unit"]}
    result["metrics"] = values
    result["device"] = device_info
    if traced:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = check.as_json(numbers, limits)
    return result, check.lines(numbers, limits)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = manifest.cell(args.workload)
    except (manifest.ManifestError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import fastdfs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} in the run's process",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
