"""Headline benchmark of the port: dedup-ingest fingerprint throughput,
GB/s per card.

The port of the repository's root ``bench.py``, which drives the JAX
package's two Pallas kernels: the same data, rounds, rules and output
fields, on the port's two hand-written kernels (``csrc/sha1.cu`` and
``csrc/minhash_survivor.cu``).  Run from the repository root:

    python -m fastdfs_tpu_torch.bench [--multichip]

The flagship leg (``_bench_gpu``) times a step of ``sha1_batch_cuda``
and ``minhash_batch_cuda`` (the padded entries, thin adapters over the
ragged kernels) over 8192 seeded, full-length 64 KiB rows (512 MB a
dispatch) already on the card: ``PIPELINE`` steps are issued, then one
fence copies every step's digests and signatures back to the host, as
the storage path must (the digests drive the dedup index).  One warm-up
step comes first, outside the measured rounds.  Rounds run until both
``MIN_ROUNDS`` and ``MIN_SECONDS`` are met, up to ``MAX_ROUNDS``; the
line carries the whole distribution (``rank_stats``) and the
contention rule, ``(max-min)/median > 0.30``.  After the rounds, outside
the clock: the first rows' digests against hashlib and a few rows'
signatures against the plain twin (``ops.minhash.minhash_batch``) on the
CPU, each kernel's device time for one dispatch under torch.profiler,
and the single-core hashlib rate over 256 rows (``vs_baseline``).

``--multichip`` runs the fan-out leg instead: ``make_fingerprint_step``
over ``fingerprint_mesh(k)`` for k in {1, all visible cards}, per-card
and aggregate GB/s and the 1 -> N scaling ratio (metric
``dedup_ingest_GBps_multichip``).  The port's step takes the whole batch
and moves each rank's rows to its card, so on more than one card those
copies fall inside the clock; on one card there are none.

Prints ONE JSON line on stdout and exits 0 whatever happens.  Without
CUDA the line has ``ok: false``, an ``error`` and ``value: null``, and
nothing is measured: a CPU rate is never reported under the card's
metric.  ``_FDFS_BENCH_SMOKE=1`` shrinks every leg to seconds.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from fastdfs_tpu_torch.ops import resolve_device
from fastdfs_tpu_torch.ops.cuda_minhash import minhash_batch_cuda
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda
from fastdfs_tpu_torch.ops.gear_cdc import CDC_POLICY_DEFAULT
from fastdfs_tpu_torch.ops.minhash import minhash_batch
from fastdfs_tpu_torch.ops.sha1 import digest_bytes
from fastdfs_tpu_torch.parallel.ingest_step import (fingerprint_mesh,
                                                    make_fingerprint_step)
from fastdfs_tpu_torch.parallel.mesh import cuda_devices
from fastdfs_tpu_torch.tools.timing import card_line, kernel_device_ms

_SMOKE = os.environ.get("_FDFS_BENCH_SMOKE") == "1"

CHUNK_KB = 64
N_CHUNKS = 32 if _SMOKE else 8192      # 512 MB per dispatch (full size)
PIPELINE = 2 if _SMOKE else 8
MIN_ROUNDS = 2 if _SMOKE else 7
MAX_ROUNDS = 3 if _SMOKE else 15
MIN_SECONDS = 0.0 if _SMOKE else 8.0   # minimum total measured wall-clock
CONTENTION_SPREAD = 0.30  # (max-min)/median above this => contended

METRIC = "dedup_ingest_GBps_per_chip"
METRIC_MULTICHIP = "dedup_ingest_GBps_multichip"
DIGEST_ROWS = 64    # rows whose digests are held to hashlib
SIG_ROWS = 8        # rows whose signatures are held to the plain twin
PROFILE_CALLS = 3   # dispatches under torch.profiler
# The device kernels a flagship step launches, by the label the line
# gives their device ms under.
KERNELS = {"sha1": "sha1_ragged_kernel", "sketch": "sketch_ragged_kernel"}


def _provenance() -> dict:
    """Fields every line carries: the cut policy the port defaults to,
    the card count and card the number belongs to, and the host's CPU
    count (the hashlib baseline is a number of that host)."""
    return {"cdc_policy": CDC_POLICY_DEFAULT, "smoke": _SMOKE,
            "host_cpus": os.cpu_count(),
            "n_devices": torch.cuda.device_count(), "backend": "cuda",
            "card": card_line() if torch.cuda.is_available() else None}


def _ru():
    """getrusage snapshot for per-phase CPU accounting, or None where
    the stdlib resource module is unavailable (non-POSIX)."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF)
    except ImportError:
        return None


def _ru_delta(a, b) -> dict | None:
    """Named user/system CPU seconds burned between two _ru() snaps: a
    phase whose wall time dwarfs its CPU time was waiting (the card, the
    disk), not computing."""
    if a is None or b is None:
        return None
    return {"utime_s": round(b.ru_utime - a.ru_utime, 3),
            "stime_s": round(b.ru_stime - a.ru_stime, 3)}


def _phase_rusage(marks: dict) -> dict:
    """{"phase_rusage": {...}, "maxrss_kb": N} from ordered phase-name
    -> _ru() snapshot marks (first mark is the baseline)."""
    names = list(marks)
    out = {}
    for prev, cur in zip(names, names[1:]):
        d = _ru_delta(marks[prev], marks[cur])
        if d is not None:
            out[cur] = d
    last = marks[names[-1]]
    return {"phase_rusage": out,
            "maxrss_kb": getattr(last, "ru_maxrss", None)}


def rank_stats(rates: list[float]) -> dict:
    """The headline over per-round rates: the median round, the whole
    distribution, the contention flag and, when contended, the median of
    the upper half as the steady-state estimate."""
    srt = sorted(rates)
    n = len(srt)
    median = srt[n // 2]
    q1, q3 = srt[n // 4], srt[(3 * n) // 4]
    spread = (srt[-1] - srt[0]) / median if median else 0.0
    contended = spread > CONTENTION_SPREAD
    out = {
        "value": round(median, 4),
        "rounds": n,
        "dispersion": {
            "min": round(srt[0], 4),
            "median": round(median, 4),
            "max": round(srt[-1], 4),
            "iqr_rel": round((q3 - q1) / median, 4) if median else 0.0,
            "spread_rel": round(spread, 4),
        },
        "contended": contended,
        "contention_rule": f"(max-min)/median > {CONTENTION_SPREAD}",
    }
    if contended:
        upper = srt[n // 2:]
        out["value_uncontended"] = round(upper[len(upper) // 2], 4)
    return out


def flagship_data(n_chunks: int = N_CHUNKS, row_bytes: int = CHUNK_KB * 1024
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The seeded rows of the reference's bench: uint8 ``(n, L)`` and
    int32 full lengths."""
    rng = np.random.RandomState(0)
    chunks = rng.randint(0, 256, size=(n_chunks, row_bytes), dtype=np.uint8)
    return chunks, np.full(n_chunks, row_bytes, dtype=np.int32)


def fingerprint_step(chunks: torch.Tensor, lens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One dispatch: uint32 digests ``(N, 5)`` and signatures ``(N, 64)``
    of padded rows (the kernels on the card, the plain twins on the
    CPU)."""
    return sha1_batch_cuda(chunks, lens), minhash_batch_cuda(chunks, lens)


def check_rows(chunks: np.ndarray, lens: np.ndarray, digests: torch.Tensor,
               sigs: torch.Tensor) -> dict:
    """The first ``DIGEST_ROWS`` rows' digests against hashlib and the
    first ``SIG_ROWS`` rows' signatures against the plain twin on the
    CPU."""
    nd, ns = min(DIGEST_ROWS, len(chunks)), min(SIG_ROWS, len(chunks))
    want = b"".join(hashlib.sha1(chunks[i, :lens[i]].tobytes()).digest()
                    for i in range(nd))
    plain = minhash_batch(torch.from_numpy(chunks[:ns]),
                          torch.from_numpy(lens[:ns]))
    return {"digest_rows": nd,
            "digests_equal": digest_bytes(digests[:nd]) == want,
            "sig_rows": ns,
            "sigs_equal": bool(torch.equal(sigs[:ns].cpu().view(torch.int32),
                                           plain.view(torch.int32)))}


def _fence(outs) -> list[tuple[torch.Tensor, ...]]:
    """Every step's outputs copied back to the host: the only point at
    which a caller has its digests."""
    return [tuple(t.cpu() for t in out) for out in outs]


def _reset_launches() -> None:
    sha1_batch_cuda.launches = minhash_batch_cuda.launches = 0


def _launches() -> dict[str, int]:
    return {"sha1_batch_cuda": sha1_batch_cuda.launches,
            "minhash_batch_cuda": minhash_batch_cuda.launches}


def _bench_gpu() -> dict:
    """The flagship leg on the card (the module's head note has its
    rules); raises without CUDA."""
    dev = resolve_device("cuda")
    L = CHUNK_KB * 1024
    chunks, lens = flagship_data()

    t_gen = time.perf_counter()
    ru = {"start": _ru()}
    dev_chunks = torch.from_numpy(chunks).to(dev)
    dev_lens = torch.from_numpy(lens).to(dev)
    torch.cuda.synchronize(dev)

    # warmup (the first call also builds the kernels)
    t_warm = time.perf_counter()
    ru["device_put"] = _ru()
    _fence([fingerprint_step(dev_chunks, dev_lens)])
    t_measure = time.perf_counter()
    ru["warmup_compile"] = _ru()

    _reset_launches()
    rates = []
    split = {"issue": [], "drain": [], "copy_back": []}
    t_total = 0.0
    while len(rates) < MAX_ROUNDS and (len(rates) < MIN_ROUNDS or
                                       t_total < MIN_SECONDS):
        t0 = time.perf_counter()
        outs = [fingerprint_step(dev_chunks, dev_lens)
                for _ in range(PIPELINE)]
        t1 = time.perf_counter()
        # The copies would wait for the card anyway; waiting first splits
        # the round into the host's issue, the card's drain and the copy.
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        host = _fence(outs)
        t3 = time.perf_counter()
        dt = t3 - t0
        t_total += dt
        rates.append(N_CHUNKS * L * PIPELINE / dt / 1e9)
        for key, a, b in (("issue", t0, t1), ("drain", t1, t2),
                          ("copy_back", t2, t3)):
            split[key].append((b - a) * 1e3)
    launches = _launches()
    t_measured = time.perf_counter()
    ru["measure"] = _ru()

    checked = check_rows(chunks, lens, *host[-1])
    t_check = time.perf_counter()
    ru["check"] = _ru()
    device_ms = kernel_device_ms(
        lambda: fingerprint_step(dev_chunks, dev_lens), KERNELS,
        PROFILE_CALLS)
    ru["device_profile"] = _ru()
    out = {
        **rank_stats(rates),
        "measured_seconds": round(t_total, 2),
        "phase_wall_s": {
            "device_put": round(t_warm - t_gen, 3),
            "warmup_compile": round(t_measure - t_warm, 3),
            "measure": round(t_measured - t_measure, 3),
            "check": round(t_check - t_measured, 3),
            "device_profile": round(time.perf_counter() - t_check, 3),
        },
        # Warmup is a separate, named phase, never part of the measured
        # rounds.
        "warmup": {"rounds": 1, "wall_s": round(t_measure - t_warm, 3),
                   "in_measure": False},
        "rows": N_CHUNKS, "row_bytes": L, "pipeline": PIPELINE,
        "steps": len(rates) * PIPELINE, "launches": launches,
        # Median ms a round: issuing the steps on the host, the card's
        # work left after that, and copying the outputs back (the fence).
        "round_split_ms": {key: round(statistics.median(v), 4)
                           for key, v in split.items()},
        "checked": checked,
        # Device ms of one dispatch by kernel, and of everything the
        # dispatch puts on the card ("all": the adapters' offsets,
        # clamps and permutation-word copy too); null if not measured.
        "kernel_device_ms": device_ms,
    }
    if device_ms is not None:
        wall_ms = N_CHUNKS * L / out["value"] / 1e6
        out["device_busy_share"] = round(device_ms["all"] / wall_ms, 4)
    out.update(_phase_rusage(ru))
    return out


def _bench_cpu() -> float:
    """The single-core baseline: hashlib SHA-1 over the first 256 of the
    same seeded rows, GB/s."""
    data, _ = flagship_data(256)
    rows = [row.tobytes() for row in data]
    t0 = time.perf_counter()
    for row in rows:
        hashlib.sha1(row).digest()
    dt = time.perf_counter() - t0
    return data.size / dt / 1e9


def _sync(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def _bench_multichip() -> dict:
    """Fan-out leg: ``make_fingerprint_step`` over 1 card and over every
    visible card, per-card and aggregate GB/s.  With one card the leg
    degrades to scaling 1.0 and says so."""
    resolve_device("cuda")   # raises without a card
    n_dev = len(cuda_devices())
    if _SMOKE:
        L, n_rows, rounds = 256, 64, 1
    else:
        L, n_rows, rounds = CHUNK_KB * 1024, N_CHUNKS, 5
    n_rows = max(n_rows - n_rows % n_dev, n_dev)
    chunks, lens = flagship_data(n_rows, L)

    legs = {}
    t_warm_total = 0.0
    ru = {"start": _ru()}
    for k in sorted({1, n_dev}):
        mesh = fingerprint_mesh(k)
        devices = [mesh.device(r) for r in range(k)]
        step = make_fingerprint_step(mesh, num_perms=64, shingle=5)
        # The batch is on the first card before the clock starts: this
        # leg prices the fan-out, not the host link.
        dev_c = torch.from_numpy(chunks).to(devices[0])
        dev_l = torch.from_numpy(lens).to(devices[0])
        _sync(devices)
        t0 = time.perf_counter()
        step(dev_c, dev_l)
        _sync(devices)
        t_warm_total += time.perf_counter() - t0
        _reset_launches()
        rates = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            step(dev_c, dev_l)
            _sync(devices)
            rates.append(n_rows * L / (time.perf_counter() - t0) / 1e9)
        srt = sorted(rates)
        legs[k] = {
            "aggregate_GBps": round(srt[len(srt) // 2], 4),
            "per_chip_GBps": round(srt[len(srt) // 2] / k, 4),
            "rounds": len(srt),
            "dispersion": {"min": round(srt[0], 4), "max": round(srt[-1], 4)},
            "launches": _launches(),
        }
    ru["measure"] = _ru()
    agg_1 = legs[1]["aggregate_GBps"]
    agg_n = legs[n_dev]["aggregate_GBps"]
    out = {
        "value": agg_n,
        "aggregate_GBps": agg_n,
        "per_chip_GBps": legs[n_dev]["per_chip_GBps"],
        "aggregate_1dev_GBps": agg_1,
        "scaling_1_to_n": round(agg_n / agg_1, 4) if agg_1 else None,
        "legs": {str(k): v for k, v in legs.items()},
        "rows": n_rows, "row_bytes": L,
        "warmup": {"wall_s": round(t_warm_total, 3), "in_measure": False},
        **_phase_rusage(ru),
    }
    if n_dev == 1:
        out["note"] = ("single local card: scaling leg degenerate "
                       "(1-device fallback)")
    return out


def _failure(metric: str, err: BaseException, **extra) -> dict:
    return {"metric": metric, "unit": "GB/s", "ok": False,
            "error": f"{type(err).__name__}: {err}"[:1000], "value": None,
            **extra}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if "--multichip" in argv:
        try:
            out = _bench_multichip()
        except Exception as e:  # noqa: BLE001 (the line reports it)
            print(json.dumps(_failure(METRIC_MULTICHIP, e, **_provenance())))
            return
        print(json.dumps({"metric": METRIC_MULTICHIP, "unit": "GB/s",
                          "ok": True, **_provenance(), **out}))
        return

    try:
        gpu = _bench_gpu()
    except Exception as e:  # noqa: BLE001 (the line reports it)
        print(json.dumps(_failure(METRIC, e, **_provenance())))
        return
    checked = gpu["checked"]
    if not (checked["digests_equal"] and checked["sigs_equal"]):
        print(json.dumps(_failure(
            METRIC, ValueError("the kernels' digests or signatures differ "
                               "from hashlib or the plain twin"),
            checked=checked, **_provenance())))
        return
    t_cpu = time.perf_counter()
    ru_cpu0 = _ru()
    cpu_gbps = _bench_cpu()
    gpu["phase_wall_s"]["cpu_baseline"] = round(time.perf_counter() - t_cpu, 3)
    d = _ru_delta(ru_cpu0, _ru())
    if d is not None:
        gpu.setdefault("phase_rusage", {})["cpu_baseline"] = d
    print(json.dumps({
        "metric": METRIC,
        "unit": "GB/s",
        "ok": True,
        "vs_baseline": round(gpu["value"] / cpu_gbps, 4),
        "cpu_baseline_GBps": round(cpu_gbps, 4),
        **_provenance(),
        **gpu,
    }))


if __name__ == "__main__":
    # The contract is one JSON line on stdout and rc 0 whatever the card
    # or its runtime does; os._exit skips the teardown of a runtime that
    # may be broken.
    try:
        main()
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as e:  # noqa: BLE001
        print(json.dumps(_failure(METRIC_MULTICHIP if "--multichip" in
                                  sys.argv[1:] else METRIC, e)))
    sys.stdout.flush()
    os._exit(0)
