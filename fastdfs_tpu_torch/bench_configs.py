"""Benchmark configs 1-14 of the repository's root ``bench_configs.py``
on the port.

One JSON artifact per config, in ``--out`` (``bench_torch_out/`` at the
repository root by default):

  1. one storage node, 256 KB random pieces, exact dedup: the native
     load driver ``fdfs_load`` uploads (each payload twice) and reads
     back through a tracker and ``fdfs_storaged`` (``dedup_mode = cpu``,
     the access log on), with the single-core CRC32 and SHA-1 rates as
     the CPU baseline column; no kernel runs;
  2. one storage node, gear CDC over a text corpus: the real daemon
     ingest (``fdfs_storaged`` behind ``fdfs_trackerd``, 4 client
     connections, the access log on) once with ``dedup_mode = cpu`` and
     once with ``dedup_mode = sidecar`` behind a supervised
     ``python -m fastdfs_tpu_torch.sidecar`` on the card, each with its
     per-stage table and the daemons' stats before and after; plus the
     host's serial chunker and ``fdfs_codec cdc-bench`` on the first
     document;
  3. one tracker and a two-storage group, exact dedup over mixed
     binaries: serial ingest and the wait for full replication, in both
     dedup modes, one sidecar serving both daemons, with the sync wire
     accounting from the stage tables;
  4. MinHash near-duplicate detection on synthetic web-crawl HTML
     (shingle 5), **the recall referee**: every document is signed by
     the fused sketch kernel (``minhash_batch_cuda``) fed through
     ``ops.streaming.stream_batches``, and retrieval through
     ``MinHashLSHIndex(64, 16)`` is held to the corpus's ground truth
     (target recall@1 >= 0.98) and to an independent textbook CPU
     MinHash on a subset;
  5. the 4-node storage group analogue: the distributed ingest step over
     a (2, 2, 2) mesh of eight ranks, all on one card (or the CPU), with
     the digest all-gather, the sharded near-dup query and the pmax;
  6. wire dedup on the ingest edge: three passes (cold, warm, each
     blob's tail edited) of negotiated uploads of 256 KB blobs to one
     storage, each fingerprinted by the port's client on the card (one
     gear CDC and one SHA-1 launch an upload), with the wire bytes each
     pass ships and the kernels' launches;
  7. scrub overhead: foreground upload and download p50/p99 with the
     daemon's scrubber off, paced at 16 MB/s and unpaced; no kernel
     runs;
  8. the read path: cold and warm downloads at ``read_cache_mb`` 0 and
     64, every byte compared, and a ranged download in parallel 4
     against a single stream; no kernel runs;
  9. the slab-packed chunk store: unique 4 KB files ingested and read
     back by ``fdfs_load`` with slab packing off and on (inode, files on
     disk and open-fd counts), then 80% deleted and the slabs compacted
     under byte-checked downloads; no kernel runs;
 10. multi-group scale-out: one open-loop zipfian download load offered
     to one group and to three behind a placement-mode tracker, then
     group3 drained by the rebalance migrator; no kernel runs;
 11. the RS(3, 2) erasure-coded cold tier: a two-member group demoted
     from 2x replication to stripes, and m = 2 shards of every stripe
     rebuilt from parity, unpaced and at 2 MB/s; no kernel runs (the
     daemons code on their CPUs);
 12. the serving edge: one open-loop download load offered to a
     1-reactor and a 4-reactor storage, through one client connection
     and through a pool, with the accept spread, the vectored-read
     coalescing, byte identity through the port's ranged downloader and
     a flamegraph of each arm taken mid-load by the port's CLI; no
     kernel runs;
 13. SLO-driven admission control: one priority-mixed open-loop
     download load at 1.7x the calibrated capacity against a storage
     with admission off and one with it on, plus a half-capacity leg;
     no kernel runs;
 14. heat-driven hot replication: a 90%-hot read mix against three
     groups with the tracker's hot-map policy off and on, read through
     the port's client and its hot routing; no kernel runs.

Run from the repository root:

    python -m fastdfs_tpu_torch.bench_configs [--config 0|1|...|14]
        [--scale F | --full] [--out DIR] [--device cuda|cpu]

``--config 0``, the default, runs every config in order.  ``--scale`` is
the fraction of the nominal corpus size (``NOMINAL``) that the run
builds (``DEFAULT_SCALE`` by default); ``--full`` runs the nominal size
and overrides it.  The artifact records ``scaled_bytes`` beside
``nominal_bytes``.  The rates in an artifact are the card's on a
``cuda`` run and null on a ``cpu`` run, which checks the same control
flow on the plain twins; configs 1-3 and 6-11 keep the rates of their
daemons, which are the host's own.  The daemons and ``fdfs_load`` come
from ``tests/torch_native.py`` (built with g++ when the checkout has
none).

The daemon fails open to flat files when its sidecar does not answer,
so a sidecar leg counts only without restarts, errors, upload retries
or a watchdog re-exec, and with every byte fingerprinted
(``leg_faults``); configs 2 and 3 write their artifact and then raise
when it does not.  Config 6 does the same on the card unless every
upload launched each kernel as it should (``launch_faults``).
``--device cuda`` without a card raises before any daemon starts, and
neither the sidecar nor the client falls back to the CPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import hashlib
import importlib.util
import json
import os
import random
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from fastdfs_tpu_torch.client import (FdfsClient, StorageClient,
                                      fingerprint_buffer)
from fastdfs_tpu_torch.dedup.index import MinHashLSHIndex
from fastdfs_tpu_torch.monitor import hist_quantile
from fastdfs_tpu_torch.ops import resolve_device
from fastdfs_tpu_torch.ops.cuda_gear import gear_candidates_cuda
from fastdfs_tpu_torch.ops.cuda_minhash import minhash_batch_cuda
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import chunk_stream_ref, gear_window
from fastdfs_tpu_torch.ops.minhash import minhash_batch
from fastdfs_tpu_torch.ops.streaming import stream_batches
from fastdfs_tpu_torch.parallel import distributed_ingest_step, make_mesh
from fastdfs_tpu_torch.tools.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "bench_torch_out")

NOMINAL = {1: 1 << 30, 2: 10 << 30, 3: 50 << 30, 4: 100 << 30,
           5: 500 << 30, 6: 10 << 30, 7: 10 << 30, 8: 10 << 30,
           9: 100_000 * 4096, 10: 4 << 30, 11: 2 << 30, 12: 2 << 30,
           13: 1 << 30, 14: 2 << 30}
DEFAULT_SCALE = {1: 0.25, 2: 1 / 32.0, 3: 1 / 64.0, 4: 1 / 40.0,
                 5: 1 / 2000.0, 6: 1 / 256.0, 7: 1 / 256.0, 8: 1 / 64.0,
                 9: 0.1, 10: 1 / 64.0, 11: 1 / 256.0, 12: 1 / 128.0,
                 13: 1 / 128.0, 14: 1 / 64.0}

BATCH = 256            # documents a streamed batch
STREAM_DEPTH = 3       # batches in flight
RESIDENT_DISPATCHES = 8
REFEREE_QUERIES = 512
C5_ITERATIONS = 16

HB = "heart_beat_interval = 1\nstat_report_interval = 1"
INGEST_WORKERS = 4     # config 2's client connections
REPLICATION_WAIT_S = 300.0  # config 3's wait for every file's replica
# Config 9's wait before it reads ``store.inodes_used`` after an ingest:
# the daemon refreshes that gauge on its heartbeat (every second under
# HB, on a whole-second clock), and an ingest of the smallest corpus
# (200 files, ~0.2 s) ends between two beats.  The reference reads at
# once, which its 10,000-file ingests outlast.
INODE_GAUGE_S = 2.5
SIDECAR_MAX_RSS_MB = 49152
SIDECAR_START_S = 600  # a first start builds the kernels
# What the sidecar's RSS watchdog prints before it re-execs the process.
REEXEC_MARK = "re-exec (state saved)"


def emit(out_dir: str, config: int, payload: dict) -> dict:
    """Write ``config{N}.json`` and print its scalar fields as one JSON
    line; returns the artifact."""
    payload = {"config": config, **payload}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"config{config}.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps({"config": config,
                      **{k: payload[k] for k in payload
                         if isinstance(payload[k], (int, float, str, bool))}}))
    return payload


def _load_by_path(name: str, *parts: str):
    """A file of the repository outside the package, loaded by its path
    (a host may have another package named ``tests`` or ``tools``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _native():
    """``tests/torch_native.py``: the daemons' paths, build and start."""
    return _load_by_path("fdfs_bench_native", "tests", "torch_native.py")


@functools.cache
def _access_log_stages():
    """``tools/access_log_stages.py`` (it imports no package)."""
    return _load_by_path("fdfs_access_log_stages", "tools",
                         "access_log_stages.py")


def _upload_retry(cli, data, timeout=25.0, **kw):
    deadline = time.time() + timeout
    while True:
        try:
            return cli.upload_buffer(data, **kw)
        except Exception:
            if time.time() >= deadline:
                raise
            time.sleep(0.5)


def _cluster(tmp, device, n_storages=1, dedup_mode="cpu", sidecar_sock="",
             access_log=False, keys="", first_ip=60):
    """A tracker and ``n_storages`` storages of group1 (with ``keys``
    added to their conf; two or more bind 127.0.0.``first_ip`` and up),
    and a client."""
    native = _native()
    storaged, trackerd, _ = native.native_binaries()
    extra = (HB + ("\nuse_access_log = true" if access_log else "")
             + ("\n" + keys if keys else ""))
    tr = native.start_tracker(trackerd, os.path.join(tmp, "tr"))
    sts = []
    try:
        for i in range(n_storages):
            ip = ("127.0.0.1" if n_storages == 1
                  else f"127.0.0.{first_ip + i}")
            sts.append(native.start_storage(
                storaged, os.path.join(tmp, f"st{i}"), ip=ip,
                trackers=[f"127.0.0.1:{tr.port}"], dedup_mode=dedup_mode,
                dedup_sidecar=sidecar_sock, extra=extra))
    except Exception:
        _stop(tr, sts)
        raise
    cli = FdfsClient([f"127.0.0.1:{tr.port}"], device=device)
    return tr, sts, cli


def _start_sidecar(tmp: str, device: torch.device, log_path: str,
                   log_mode: str = "w"):
    """Launch ``python -m fastdfs_tpu_torch.sidecar`` on ``device`` from
    the repository root (so the module is this checkout's) and wait
    until its socket accepts, which it does after the warm-up has built
    and run the kernels.  Its output goes to ``log_path``."""
    sock = os.path.join(tmp, "dedup.sock")
    state = os.path.join(tmp, "sc_state")
    os.makedirs(state, exist_ok=True)
    args = [sys.executable, "-m", "fastdfs_tpu_torch.sidecar",
            "--socket", sock, "--state-dir", state,
            # Generous watchdog: restart rather than exhaust the host if a
            # pass outgrows it (a re-exec voids the leg, leg_faults).
            "--max-rss-mb", str(SIDECAR_MAX_RSS_MB),
            "--platform", device.type]
    with open(log_path, log_mode) as log:
        proc = subprocess.Popen(args, cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT)
    deadline = time.time() + SIDECAR_START_S
    while time.time() < deadline:
        if proc.poll() is not None:
            with open(log_path, errors="replace") as fh:
                tail = fh.read()[-2000:]
            raise RuntimeError(f"sidecar died during warmup (exit "
                               f"{proc.returncode}): {tail}")
        if os.path.exists(sock):
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.connect(sock)
                return proc, sock
            except OSError:
                pass
        time.sleep(0.5)
    proc.kill()
    proc.wait()
    raise TimeoutError("sidecar did not come up")


def _sidecar_stats(sock_path: str) -> dict:
    """Read the sidecar's service counters (DEDUP_COMMIT `stats`)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(60)
        s.connect(sock_path)
        body = b"stats"
        s.sendall(struct.pack(">qBB", len(body), 122, 0) + body)
        hdr = b""
        while len(hdr) < 10:
            part = s.recv(10 - len(hdr))
            if not part:
                raise OSError("sidecar closed")
            hdr += part
        ln = struct.unpack(">q", hdr[:8])[0]
        resp = b""
        while len(resp) < ln:
            part = s.recv(ln - len(resp))
            if not part:
                raise OSError("sidecar closed mid-response")
            resp += part
    return json.loads(resp)


def _stage_table(storage_base: str) -> dict:
    """Aggregate the daemon's per-stage access log (upload rows)."""
    path = os.path.join(storage_base, "logs", "access.log")
    return _access_log_stages().aggregate(path) if os.path.exists(path) else {}


class _SidecarSupervisor:
    """Keeps a sidecar alive for the duration of a bench pass.

    A sidecar that dies is respawned on the same device, reloading its
    state from the same state dir (in production the init.d wrapper
    does this), so a crash degrades to a fail-open window instead of
    voiding the artifact; restarts are counted for it."""

    MAX_RESTARTS = 10

    def __init__(self, tmp: str, device: torch.device, log_path: str):
        self.tmp = tmp
        self.device = device
        self.log_path = log_path
        self.restarts = 0
        self.proc, self.sock = _start_sidecar(tmp, device, log_path)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(2.0):
            if self.proc.poll() is None:
                continue
            if self.restarts >= self.MAX_RESTARTS:
                return
            self.restarts += 1
            print(f"sidecar died (exit {self.proc.returncode}); "
                  f"respawn #{self.restarts}", flush=True)
            try:
                proc, _ = _start_sidecar(self.tmp, self.device,
                                         self.log_path, log_mode="a")
            except (RuntimeError, TimeoutError, OSError):
                continue  # next tick retries (until MAX_RESTARTS)
            # stop() may have fired during the warm-up: the thread owns
            # this fresh spawn until it is published, so it kills it
            # here rather than orphan it holding the card.
            if self._stop.is_set():
                proc.terminate()
                proc.wait()
                return
            self.proc = proc

    def stop(self) -> None:
        self._stop.set()
        # The watch thread may be mid-respawn; it kills its own spawn
        # when it notices the stop flag, so a bounded join here cannot
        # leak a live process.
        self._thread.join(timeout=15)
        if self.proc.poll() is None:
            self.proc.terminate()
            self.proc.wait()


def _reexecs(log_path: str) -> int:
    """The RSS watchdog's re-execs that the sidecar's log shows."""
    try:
        with open(log_path, errors="replace") as fh:
            return fh.read().count(REEXEC_MARK)
    except OSError:
        return 0


def _with_sidecar(run_fn, device: torch.device) -> dict:
    """Start a supervised sidecar on ``device``, run ``run_fn(sock)``,
    attach the engine-serialization pricing from the sidecar's stats
    (and, in them, the watchdog re-execs its log shows), and always tear
    the process down.  Returns the run's metric dict, or {"error": ...}
    when the sidecar cannot come up at all."""
    sc_tmp = tempfile.mkdtemp(prefix="bench_sc_")
    # Per-launch log outside the artifacts dir (a later config must not
    # clobber the post-mortem of an earlier crash); kept only when the
    # artifact names it.
    log_path = os.path.join(tempfile.gettempdir(),
                            f"fastdfs_sidecar_{os.path.basename(sc_tmp)}.log")
    result = None
    sup = None
    keep_log = False
    try:
        sup = _SidecarSupervisor(sc_tmp, device, log_path)
        result = run_fn(sup.sock)
        result["sidecar_platform"] = device.type
        result["sidecar_restarts"] = sup.restarts
        # Stats are best-effort: a sidecar that died mid-run must not
        # discard the completed run's metrics (the daemon fails open,
        # so the pass itself still finished).  After a respawn the
        # counters cover only the current process, recorded as such.
        try:
            stats = _sidecar_stats(sup.sock)
            busy = (stats.get("lock_wait_us", 0)
                    + stats.get("engine_us", 1))
            stats["lock_wait_fraction"] = round(
                stats.get("lock_wait_us", 0) / max(busy, 1), 4)
            stats["watchdog_reexecs"] = _reexecs(log_path)
            if sup.restarts:
                stats["note"] = ("counters cover the post-respawn "
                                 "process only")
            result["sidecar_stats"] = stats
        except OSError as e:
            result["sidecar_stats_error"] = str(e)
            result["sidecar_stderr_log"] = log_path
            keep_log = True
        return result
    except (RuntimeError, TimeoutError, OSError) as e:
        keep_log = True
        if result is not None:
            result["error"] = str(e)
            return result
        return {"error": str(e), "sidecar_stderr_log": log_path}
    finally:
        if sup is not None:
            sup.stop()
        shutil.rmtree(sc_tmp, ignore_errors=True)
        if not keep_log and os.path.exists(log_path):
            os.unlink(log_path)


def leg_faults(leg: dict, scaled_bytes: int) -> list[str]:
    """Why a sidecar leg does not count (empty when it does): a restart,
    an error, a retried upload, a watchdog re-exec, or bytes that did
    not reach the sidecar.  Every document and file is over the daemon's
    64 KiB ``dedup_chunk_threshold``, so every byte must."""
    faults = []
    if "error" in leg:
        faults.append(f"error: {leg['error']}")
    if leg.get("sidecar_restarts"):
        faults.append(f"{leg['sidecar_restarts']} sidecar restarts")
    if leg.get("upload_retries"):
        faults.append(f"{leg['upload_retries']} upload retries")
    stats = leg.get("sidecar_stats")
    if stats is None:
        faults.append(f"no sidecar stats: {leg.get('sidecar_stats_error')}")
    else:
        if stats.get("watchdog_reexecs"):
            faults.append(f"{stats['watchdog_reexecs']} watchdog re-execs")
        if stats.get("fingerprint_bytes") != scaled_bytes:
            faults.append(f"fingerprint_bytes {stats.get('fingerprint_bytes')}"
                          f" != scaled_bytes {scaled_bytes}")
    return faults


def _require_counted(config: int, leg: dict, scaled_bytes: int) -> None:
    faults = leg_faults(leg, scaled_bytes)
    if faults:
        raise RuntimeError(f"config {config}: the sidecar leg does not "
                           f"count: {'; '.join(faults)}")


_EVIDENCE_PREFIXES = ("op.", "nio.", "dio.", "cache.", "ingest.", "scrub.",
                      "sync.", "store.", "events.", "download.")


def _stats_evidence(cli) -> dict:
    """Per-storage registry snapshot for the artifact's evidence trail:
    counters and gauges under the diagnostic prefixes plus histogram
    summaries (count/sum), keyed by node address, taken before and after
    each measured phase so that a rate ships its daemon-side context.
    Best-effort: a dead node is an error entry, never a crashed bench."""
    out: dict = {}
    try:
        rows = _storage_rows(cli)
    except Exception as e:  # noqa: BLE001
        return {"error": str(e)}
    for r in rows:
        addr = f"{r['ip']}:{r['port']}"
        try:
            with StorageClient(r["ip"], r["port"], device=cli.device) as sc:
                reg = sc.stat()
        except Exception as e:  # noqa: BLE001
            out[addr] = {"error": str(e)}
            continue
        ev = {k: v for k, v in reg.get("counters", {}).items()
              if k.startswith(_EVIDENCE_PREFIXES) and v}
        ev.update({k: v for k, v in reg.get("gauges", {}).items()
                   if k.startswith(_EVIDENCE_PREFIXES) and v})
        for name, h in reg.get("histograms", {}).items():
            if h.get("count"):
                ev[name + ".count"] = h["count"]
                ev[name + ".sum"] = h["sum"]
        out[addr] = ev
    return out


def _stop(tr, sts):
    for s in sts:
        s.stop()
    tr.stop()


def _storage_rows(cli):
    return cli._tracker().list_storages("group1")


def _settled_saved(cli, idx=0, timeout=20.0):
    """dedup_bytes_saved after the beat-reported stat stops moving: two
    consecutive equal reads (stats reach the tracker every second)."""
    last = -1
    deadline = time.time() + timeout
    while time.time() < deadline:
        rows = _storage_rows(cli)
        cur = int(rows[idx].get("dedup_bytes_saved", 0)) if rows else 0
        if cur == last:
            return cur
        last = cur
        time.sleep(1.2)
    return last


def _require(ok: bool, what) -> None:
    """One of the reference's asserts, kept under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _run_load(load: str, *args: str) -> dict | None:
    """``fdfs_load`` with ``args``; raises with its stderr if it fails.
    Returns its pool-stats line, the ``{"conns_budget": ...}`` JSON that
    it prints on stdout after its workers join, or None without one."""
    out = subprocess.run([load, *args], capture_output=True, timeout=3600)
    _require(out.returncode == 0, out.stderr.decode(errors="replace"))
    conns = None
    for line in out.stdout.decode(errors="replace").splitlines():
        if line.startswith('{"conns_budget"'):
            conns = json.loads(line)
    return conns


def _combine(load: str, *result_files: str) -> dict:
    """``fdfs_load combine``: the summary of one or more result files."""
    out = subprocess.run([load, "combine", *result_files],
                         capture_output=True, timeout=600)
    _require(out.returncode == 0, out.stderr.decode(errors="replace"))
    return json.loads(out.stdout.decode())


def _restart_storage(tmp: str, tr, sts: list, keys: str):
    """Stop storage 0 of a one-storage ``_cluster`` and start it again on
    the same port with ``keys`` added to its conf (``_cluster``'s conf
    has no scrub or cache keys); returns the new daemon, which also
    takes its place in ``sts``."""
    native = _native()
    st = sts[0]
    st.stop()
    sts[0] = native.start_storage(
        native.native_binaries()[0], os.path.join(tmp, "st0"), ip=st.ip,
        port=st.port, trackers=[f"127.0.0.1:{tr.port}"],
        dedup_mode="cpu", extra=HB + "\n" + keys)
    return sts[0]


def config1(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """256 KB random chunks, exact dedup, through the real daemon, driven
    by the native load driver (``fdfs_load``: C++ worker threads on the
    client side, so per-op latency percentiles are the daemon's), with
    the scalar CRC32/SHA1 single-core loop as the CPU baseline column.
    No kernel runs: the daemon dedups on its CPU and ``fdfs_load`` is the
    client; the port's client on ``device`` makes only the plain wait-in
    upload and reads the stats."""
    dev = resolve_device(device)
    total = int(NOMINAL[1] * scale)
    piece = 256 << 10
    n = max(total // piece, 8)
    rng = np.random.RandomState(1)
    sample = rng.randint(0, 256, 16 << 20, dtype=np.uint8).tobytes()

    # CPU baseline: the reference's scalar per-byte loops, one core.
    t0 = time.perf_counter()
    zlib.crc32(sample)
    crc_gbps = len(sample) / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    hashlib.sha1(sample)
    sha_gbps = len(sample) / (time.perf_counter() - t0) / 1e9

    load = _native().load_binary()
    tmp = tempfile.mkdtemp(prefix="bench_c1_")
    tr, sts, cli = _cluster(tmp, dev, access_log=True)
    try:
        _upload_retry(cli, sample[:4096], ext="bin")  # wait-in
        taddr = f"127.0.0.1:{tr.port}"
        threads = 4
        results = {}
        evidence = {"before": _stats_evidence(cli)}
        phase_wall = {}
        # upload phase: every payload uploaded ~twice (n//2 distinct)
        up_res = os.path.join(tmp, "up.result")
        t_up = time.perf_counter()
        subprocess.run([load, "upload", taddr, str(n), str(piece),
                        str(threads), up_res, str(max(n // 2, 1))],
                       check=True)
        phase_wall["upload"] = round(time.perf_counter() - t_up, 3)
        evidence["after_upload"] = _stats_evidence(cli)
        # download phase: read the whole corpus back once
        down_res = os.path.join(tmp, "down.result")
        t_down = time.perf_counter()
        subprocess.run([load, "download", taddr, up_res + ".ids", str(n),
                        str(threads), down_res], check=True)
        phase_wall["download"] = round(time.perf_counter() - t_down, 3)
        evidence["after"] = _stats_evidence(cli)
        for phase, res in (("upload", up_res), ("download", down_res)):
            out = subprocess.run([load, "combine", res],
                                 stdout=subprocess.PIPE, check=True).stdout
            results[phase] = json.loads(out)
        saved = _settled_saved(cli)
        base = os.path.join(tmp, "st0")
        _stop(tr, sts)  # flush + close the access log before reading it
        tr = sts = None
        table = _stage_table(base)
        up = results["upload"]
        return emit(out_dir, 1, {
            "description": "single node, 256KB random chunks, exact dedup "
                           "— native fdfs_load drivers (C++ client side); "
                           "no kernel runs (the daemon dedups on its CPU)",
            "nominal_bytes": NOMINAL[1], "scaled_bytes": up["bytes"],
            "card": card_line() if dev.type == "cuda" else None,
            "uploads": up["ops"], "client_threads": threads,
            "seconds": up["wall_seconds"],
            "daemon_ingest_GBps": up["GBps"],
            "uploads_per_sec": up["qps"],
            "upload_lat_us": {k: up[f"lat_{k}_us"]
                              for k in ("mean", "p50", "p95", "p99")},
            "download_GBps": results["download"]["GBps"],
            "downloads_per_sec": results["download"]["qps"],
            "download_lat_us": {k: results["download"][f"lat_{k}_us"]
                                for k in ("mean", "p50", "p95", "p99")},
            "errors": up["errors"] + results["download"]["errors"],
            "cpu_crc32_GBps": round(crc_gbps, 3),
            "cpu_sha1_GBps": round(sha_gbps, 3),
            "dedup_bytes_saved": saved,
            "upload_stages": table.get("upload"),
            "download_stages": table.get("download"),
            "phase_wall_s": phase_wall,
            "daemon_stats": evidence,
        })
    finally:
        cli.close()
        if tr is not None:
            _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)


def _text_corpus(total: int, seed=2) -> list[bytes]:
    """Web-text-like corpus with cross-document repetition: fresh prose
    mixed with shared sections (boilerplate, quoted passages) that recur
    across documents.  Byte for byte the reference's generator."""
    rng = random.Random(seed)
    nprng = np.random.RandomState(seed)
    words = np.array([f"w{j}" for j in range(5000)], dtype=object)

    def prose(n_bytes: int) -> bytes:
        # a period roughly every 6-18 words; draw until the requested
        # size is covered
        out = bytearray()
        while len(out) < n_bytes:
            draw = words[nprng.randint(0, len(words),
                                       max((n_bytes - len(out)) // 5 + 32,
                                           16))]
            i = 0
            while i < len(draw) and len(out) < n_bytes:
                k = rng.randint(6, 18)
                out += " ".join(draw[i:i + k]).encode() + b". "
                i += k
        return bytes(out[:n_bytes])

    shared_sections = [prose(rng.randint(32 << 10, 128 << 10))
                       for _ in range(24)]
    docs = []
    made = 0
    while made < total:
        doc = bytearray()
        target = rng.randint(1 << 20, 8 << 20)
        while len(doc) < target:
            if rng.random() < 0.5:
                doc += rng.choice(shared_sections)
            else:
                doc += prose(rng.randint(16 << 10, 64 << 10))
        docs.append(bytes(doc))
        made += len(doc)
    return docs


def _daemon_ingest(docs: list[bytes], dedup_mode: str, device: torch.device,
                   sidecar_sock: str = "", ext: str = "txt",
                   workers: int = INGEST_WORKERS) -> dict:
    """Upload ``docs`` through a fresh single-node cluster (with the
    access log on) over ``workers`` concurrent client connections;
    returns ingest metrics and the per-stage table of the upload
    command."""
    tmp = tempfile.mkdtemp(prefix=f"bench_ingest_{dedup_mode}_")
    tr, sts, cli = _cluster(tmp, device, dedup_mode=dedup_mode,
                            sidecar_sock=sidecar_sock, access_log=True)
    try:
        _upload_retry(cli, docs[0][:4096], ext=ext)  # wait-in (sub-threshold)
        taddr = f"127.0.0.1:{tr.port}"
        retries = [0] * workers

        def feed(w):
            # Per-upload retry on a fresh connection, counted: a retried
            # upload voids a sidecar leg (leg_faults).  The timeout is
            # generous: throughput is the metric, latency comes from the
            # stage tables.
            c = FdfsClient([taddr], timeout=600.0, device=device)
            done = 0
            for j in range(w, len(docs), workers):
                for attempt in range(3):
                    try:
                        c.upload_buffer(docs[j], ext=ext)
                        break
                    except Exception:
                        retries[w] += 1
                        c.close()
                        if attempt == 2:
                            raise RuntimeError(
                                f"upload {j} failed after retries")
                        time.sleep(2)
                        c = FdfsClient([taddr], timeout=600.0, device=device)
                done += len(docs[j])
            c.close()
            return done

        evidence = {"before": _stats_evidence(cli)}
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            sent = sum(ex.map(feed, range(workers)))
        dt = time.perf_counter() - t0
        evidence["after"] = _stats_evidence(cli)
        saved = _settled_saved(cli)
        base = os.path.join(tmp, "st0")
        _stop(tr, sts)  # flush + close the access log before reading it
        tr = sts = None
        table = _stage_table(base)
        return {
            "seconds": round(dt, 3),
            "daemon_ingest_GBps": round(sent / dt / 1e9, 4),
            "scaled_bytes": sent,
            "uploads": len(docs),
            "client_conns": workers,
            "upload_retries": sum(retries),
            "dedup_bytes_saved": saved,
            "dedup_ratio": round(saved / sent, 4) if sent else 0.0,
            "upload_stages": table.get("upload"),
            "phase_wall_s": {"ingest": round(dt, 3)},
            "daemon_stats": evidence,
        }
    finally:
        cli.close()
        if tr is not None:
            _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)


def config2(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Gear CDC on a text corpus: the daemon's ingest in both dedup
    modes (cpu, and the port's sidecar on ``device``), with per-stage
    attribution from the access log, plus isolated chunker rates."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total = int(NOMINAL[2] * scale)
    docs = _text_corpus(total)

    # isolated chunkers on one doc
    sample = docs[0]
    t0 = time.perf_counter()
    cuts = chunk_stream_ref(sample)
    py_serial_gbps = len(sample) / (time.perf_counter() - t0) / 1e9
    codec = _native().codec_binary()
    cpp_gbps = None
    if codec is not None:
        # cdc-bench times repeat passes inside the process (best-of), so
        # the number is the chunker, not fork+pipe startup.
        out = subprocess.run([codec, "cdc-bench", "2048", "13", "65536"],
                             input=sample, stdout=subprocess.PIPE,
                             check=True).stdout
        cpp_gbps = json.loads(out)["GBps"]

    cpu = _daemon_ingest(docs, "cpu", dev)
    sidecar = _with_sidecar(
        lambda sock: _daemon_ingest(docs, "sidecar", dev, sidecar_sock=sock),
        dev)
    if not on_card and "daemon_ingest_GBps" in sidecar:
        sidecar["daemon_ingest_GBps"] = None

    art = emit(out_dir, 2, {
        "description": "single node, gear CDC on text corpus — daemon "
                       "ingest in cpu AND sidecar (CUDA) dedup modes with "
                       "stage attribution",
        "nominal_bytes": NOMINAL[2],
        "scaled_bytes": cpu["scaled_bytes"],
        "docs": len(docs), "chunks_sample": len(cuts),
        "card": card_line() if on_card else None,
        "seconds": cpu["seconds"],
        "daemon_ingest_GBps": cpu["daemon_ingest_GBps"],
        "chunker_cpp_GBps": round(cpp_gbps, 3) if cpp_gbps else None,
        "chunker_py_serial_GBps": round(py_serial_gbps, 4),
        "dedup_bytes_saved": cpu["dedup_bytes_saved"],
        "dedup_ratio": cpu["dedup_ratio"],
        "cpu_mode": cpu,
        "sidecar_mode": sidecar,
    })
    _require_counted(2, sidecar, cpu["scaled_bytes"])
    return art


def _mixed_binaries(total: int, seed=3) -> list[bytes]:
    """Mixed binaries: random payloads, zero runs, and shared library-like
    blocks reused across files.  Byte for byte the reference's."""
    rng = np.random.RandomState(seed)
    shared_blocks = [rng.randint(0, 256, 1 << 18, dtype=np.uint8).tobytes()
                     for _ in range(16)]
    files = []
    made = 0
    while made < total:
        parts = []
        target = int(rng.randint(1 << 20, 4 << 20))
        size = 0
        while size < target:
            kind = rng.randint(4)
            if kind == 0:
                b = shared_blocks[rng.randint(len(shared_blocks))]
            elif kind == 1:
                b = bytes(1 << 17)
            else:
                b = rng.randint(0, 256, 1 << 17, dtype=np.uint8).tobytes()
            parts.append(b)
            size += len(b)
        files.append(b"".join(parts))
        made += size
    return files


def _config3_run(files: list[bytes], dedup_mode: str, device: torch.device,
                 sidecar_sock: str = "") -> dict:
    """One 2-storage ingest+replication pass; returns its metrics."""
    tmp = tempfile.mkdtemp(prefix="bench_c3_")
    tr, sts, cli = _cluster(tmp, device, n_storages=2, dedup_mode=dedup_mode,
                            sidecar_sock=sidecar_sock, access_log=True)
    try:
        t = cli._tracker()
        deadline = time.time() + 30
        while time.time() < deadline:
            groups = t.list_groups()
            if groups and groups[0]["active"] == 2:
                break
            time.sleep(0.5)
        evidence = {"before": _stats_evidence(cli)}
        t0 = time.perf_counter()
        fids = []
        sent = 0
        for f in files:
            fids.append(cli.upload_buffer(f, ext="bin"))
            sent += len(f)
        ingest_dt = time.perf_counter() - t0
        evidence["after_ingest"] = _stats_evidence(cli)
        # wait for full replication (2 replicas per file); the reference
        # ends this wait silently, and sync_recipe_replays shows it
        deadline = time.time() + REPLICATION_WAIT_S
        while time.time() < deadline:
            if all(len(t.query_fetch_all(fid)) == 2 for fid in fids):
                break
            time.sleep(0.5)
        repl_dt = time.perf_counter() - t0
        evidence["after"] = _stats_evidence(cli)
        _settled_saved(cli)
        rows = _storage_rows(cli)
        bases = [os.path.join(tmp, "st0"), os.path.join(tmp, "st1")]
        _stop(tr, sts)  # flush access logs
        tr = sts = None
        tables = [_stage_table(b) for b in bases]
        # Chunk-aware replication wire accounting: request bytes of the
        # sync ops, vs the full-copy baseline (= every logical byte once).
        sync_ops = ("sync_create", "sync_query_chunks", "sync_recipe")
        sync_wire = sum(tb.get(op, {}).get("req_bytes", 0)
                        for tb in tables for op in sync_ops)
        return {
            "scaled_bytes": sent,
            "files": len(files),
            "ingest_seconds": round(ingest_dt, 3),
            "ingest_GBps": round(sent / ingest_dt / 1e9, 4),
            "replicated_seconds": round(repl_dt, 3),
            "replicated_GBps": round(2 * sent / repl_dt / 1e9, 4),
            "dedup_bytes_saved_per_node": [
                int(r.get("dedup_bytes_saved", 0)) for r in rows],
            "sync_wire_bytes": sync_wire,
            "sync_wire_saved_vs_full_copy": sent - sync_wire,
            "sync_recipe_replays": sum(tb.get("sync_recipe", {})
                                       .get("count", 0) for tb in tables),
            "upload_stages_per_node": [tb.get("upload") for tb in tables],
            "sync_create_stages_per_node": [tb.get("sync_create")
                                            for tb in tables],
            "phase_wall_s": {"ingest": round(ingest_dt, 3),
                             "replication": round(repl_dt - ingest_dt, 3)},
            "daemon_stats": evidence,
        }
    finally:
        cli.close()
        if tr is not None:
            _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)


def config3(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """2-storage group: exact dedup + full intra-group replication, in
    both dedup modes (one shared sidecar on ``device`` serves both
    daemons)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total = int(NOMINAL[3] * scale)
    files = _mixed_binaries(total)

    cpu = _config3_run(files, "cpu", dev)
    sidecar = _with_sidecar(
        lambda sock: _config3_run(files, "sidecar", dev, sidecar_sock=sock),
        dev)
    if not on_card:
        for key in ("ingest_GBps", "replicated_GBps"):
            if key in sidecar:
                sidecar[key] = None

    art = emit(out_dir, 3, {
        "description": "1 tracker + 2 storages, SHA1 exact dedup, mixed "
                       "binaries, full replication — cpu AND sidecar "
                       "(CUDA) dedup modes",
        "nominal_bytes": NOMINAL[3], "scaled_bytes": cpu["scaled_bytes"],
        "files": cpu["files"],
        "card": card_line() if on_card else None,
        "ingest_seconds": cpu["ingest_seconds"],
        "ingest_GBps": cpu["ingest_GBps"],
        "replicated_seconds": cpu["replicated_seconds"],
        "replicated_GBps": cpu["replicated_GBps"],
        "dedup_bytes_saved_per_node": cpu["dedup_bytes_saved_per_node"],
        "cpu_mode": cpu,
        "sidecar_mode": sidecar,
    })
    _require_counted(3, sidecar, cpu["scaled_bytes"])
    return art


def _html_corpus(total: int, seed=4):
    """Synthetic web-crawl: base pages, near-duplicate variants, and
    ADVERSARIAL content — the workload MinHash near-dup retrieval exists
    for, built so recall < 1.0 is genuinely possible.

    Returns (docs, lens, truth, klass):
      truth[i] = base index a variant must retrieve (-1: not a query)
      klass[i]: 0 base / 1 span-edit variant / 2 boundary-straddling
      single-byte edits (each edited byte damages `shingle` shingles —
      the worst case per byte) / 3 shuffled-shingle distractor (same
      token multiset as a base, re-ordered: overlapping vocabulary,
      almost no shared 5-grams — bait for any unigram-ish matcher).
    """
    rng = random.Random(seed)
    words = [f"tok{j}" for j in range(8000)]
    L = 64 << 10
    n_docs = max(total // L, 32)
    n_base = max(n_docs // 4, 8)
    docs = np.zeros((n_docs, L), dtype=np.uint8)
    truth = np.full(n_docs, -1, dtype=np.int64)
    klass = np.zeros(n_docs, dtype=np.int64)

    def page(body: str) -> bytes:
        html = (f"<html><head><title>p</title></head><body>{body}"
                "</body></html>").encode()
        return (html + b" " * L)[:L]

    nprng = np.random.RandomState(seed)
    for b in range(n_base):
        body = " ".join(rng.choices(words, k=L // 8))
        docs[b] = np.frombuffer(page(body), dtype=np.uint8)
    for i in range(n_base, n_docs):
        b = rng.randrange(n_base)
        kind = rng.random()
        if kind < 0.40:  # span-edit near-dup (typo/edit model, ~0.5%)
            row = docs[b].copy()
            for _ in range(max(L // (200 * 16), 1)):
                p = nprng.randint(0, L - 16)
                row[p:p + 16] = nprng.randint(97, 123, 16, dtype=np.uint8)
            truth[i] = b
            klass[i] = 1
        elif kind < 0.80:  # scattered single-byte edits (same edited
            # byte budget as the span class, ~5x the shingle damage)
            row = docs[b].copy()
            pos = nprng.choice(L, size=max(L // 200, 1), replace=False)
            row[pos] = nprng.randint(97, 123, len(pos), dtype=np.uint8)
            truth[i] = b
            klass[i] = 2
        else:  # shuffled-shingle distractor: index pollution, never a
            # correct answer for any query
            toks = bytes(docs[b]).split(b" ")
            rng.shuffle(toks)
            row = np.frombuffer((b" ".join(toks) + b" " * L)[:L],
                                dtype=np.uint8).copy()
            klass[i] = 3
        docs[i] = row
    lens = np.full(n_docs, L, dtype=np.int32)
    return docs, lens, truth, klass


def _textbook_minhash(docs: np.ndarray, lens: np.ndarray, num_perms: int,
                      shingle: int, seed: int = 99) -> np.ndarray:
    """Independent CPU MinHash referee: the TEXTBOOK formulation (k
    universal-hash permutations over the exact shingle set, one min
    each) in plain numpy — shares no code, spec, or hash family with
    the port's ``ops.minhash`` (a survivor sketch over a single hash), so
    agreement between the two retrieval rankings is an empirical result,
    not an identity."""
    rng = np.random.RandomState(seed)
    p = np.uint64((1 << 61) - 1)  # Mersenne prime
    # a < 2^23 keeps a*x + b below 2^64 for 40-bit shingle ints (shingle
    # 5), so the mod-p hash is computed exactly in uint64.
    a = rng.randint(1, 1 << 23, size=num_perms).astype(np.uint64)
    b = rng.randint(0, 1 << 61, size=num_perms).astype(np.uint64)
    sigs = np.zeros((len(docs), num_perms), dtype=np.uint64)
    for i in range(len(docs)):
        row = docs[i, :lens[i]].astype(np.uint64)
        # pack each `shingle`-byte window into one integer
        x = np.zeros(max(len(row) - shingle + 1, 0), dtype=np.uint64)
        for k in range(shingle):
            x |= row[k:len(row) - shingle + 1 + k] << np.uint64(8 * k)
        x = np.unique(x)
        # h_j(x) = (a_j * x + b_j) mod p over the shingle set, one min
        # per permutation (vectorized (P, S) broadcast).  p is Mersenne,
        # so the reduction is shift+mask+one conditional subtract — a
        # uint64 `%` here costs ~5x the rest of the referee combined.
        y = a[:, None] * x[None, :] + b[:, None]
        y = (y >> np.uint64(61)) + (y & p)
        y = np.where(y >= p, y - p, y)
        sigs[i] = y.min(axis=1)
    return sigs


def _fetch(outs) -> list:
    """Every dispatch's signatures copied back to the host (the fence)."""
    return [t.cpu() for t in outs]


def config4(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """MinHash near-dup on HTML — the recall referee, made falsifiable.

    Three measurements, none structurally guaranteed:
      1. recall@{1,5} of the kernel path's retrieval against ground truth
         on a corpus with adversarial distractors (shuffled-shingle
         pages) and worst-case edit classes — LSH banding and 64-perm
         sketches genuinely can miss here;
      2. top-1 agreement between the kernel path and an INDEPENDENT
         textbook CPU MinHash (different hash family, different
         estimator, no shared code) on a subset;
      3. the kernel's signatures of the first batch against the plain
         twin's on the CPU, bit for bit (a correctness property of the
         kernel, reported separately: it is not the recall measurement;
         null on a CPU run, where both sides are the plain twin).
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total = int(NOMINAL[4] * scale)
    docs, lens, truth, klass = _html_corpus(total)
    n_docs = len(docs)
    n_base = int((klass == 0).sum())

    # the kernel path: the fused k = 5 sketch fed by windowed host->card
    # streaming (ops/streaming.py)
    batches = [(docs[i:i + BATCH], lens[i:i + BATCH])
               for i in range(0, n_docs, BATCH)]
    t0 = time.perf_counter()
    sigs_acc = np.concatenate(list(stream_batches(
        iter(batches), minhash_batch_cuda, depth=STREAM_DEPTH, device=dev)))
    acc_dt = time.perf_counter() - t0

    # card-resident rate (isolates the kernel from the host link)
    resident_gbps = None
    kernel_bitexact = None
    if on_card:
        db = torch.from_numpy(batches[0][0]).to(dev)
        dl = torch.from_numpy(batches[0][1]).to(dev)
        _fetch([minhash_batch_cuda(db, dl)])
        t0 = time.perf_counter()
        _fetch([minhash_batch_cuda(db, dl)
                for _ in range(RESIDENT_DISPATCHES)])
        resident_gbps = (RESIDENT_DISPATCHES * batches[0][0].size
                         / (time.perf_counter() - t0) / 1e9)
        sigs_ref0 = minhash_batch(torch.from_numpy(batches[0][0]),
                                  torch.from_numpy(batches[0][1])).numpy()
        kernel_bitexact = bool(np.array_equal(sigs_acc[:len(sigs_ref0)],
                                              sigs_ref0))

    # (1) retrieval vs ground truth: bases AND adversarial distractors
    # are indexed; each edit-variant queries for its true base.  (The
    # variants themselves stay out of the index so every query has
    # exactly one correct answer — sibling variants of the same base
    # would otherwise be equally-valid retrievals.)
    def retrieve(sigs, queries, top_k):
        idx = MinHashLSHIndex(64, 16)
        for d in range(n_docs):
            if d not in queries:
                idx.add(np.asarray(sigs[d], dtype=np.uint32)
                        if sigs.dtype != np.uint32 else sigs[d], d)
        out = {}
        for q in queries:
            got = idx.query(np.asarray(sigs[q], dtype=np.uint32)
                            if sigs.dtype != np.uint32 else sigs[q],
                            top_k=top_k, min_similarity=0.0)
            out[q] = [ref for ref, _ in got]
        return out

    queries = [int(q) for q in np.nonzero(truth >= 0)[0]]
    acc_top = retrieve(sigs_acc, set(queries), 5)
    r1 = sum(1 for q in queries if acc_top[q][:1] == [truth[q]])
    r5 = sum(1 for q in queries if truth[q] in acc_top[q])
    per_class = {}
    for cname, cid in (("span_edit", 1), ("scattered_edit", 2)):
        qs = [q for q in queries if klass[q] == cid]
        if qs:
            per_class[cname] = round(
                sum(1 for q in qs if acc_top[q][:1] == [truth[q]]) / len(qs),
                4)

    # (2) independent textbook CPU referee on a subset: do the two
    # pipelines RANK the same best match?  (Capped: the textbook path is
    # an O(perms x shingles) scalar-ish loop.)
    sub_q = queries[:min(len(queries), REFEREE_QUERIES)]
    sub_docs = sorted({*range(n_base), *sub_q})
    remap = {d: i for i, d in enumerate(sub_docs)}
    t0 = time.perf_counter()
    tb_sigs = _textbook_minhash(docs[sub_docs], lens[sub_docs],
                                num_perms=64, shingle=5)
    tb_dt = time.perf_counter() - t0

    def tb_top1(q):
        # brute-force exact top-1 under the textbook estimator
        qi = remap[q]
        scores = (tb_sigs[:n_base] == tb_sigs[qi]).mean(axis=1)
        return int(np.argmax(scores))

    agree = 0
    tb_r1 = 0
    for q in sub_q:
        t = tb_top1(q)
        agree += acc_top[q][:1] == [t]
        tb_r1 += t == truth[q]
    recall1 = r1 / len(queries) if queries else 1.0
    return emit(out_dir, 4, {
        "description": "MinHash near-dup on synthetic web-crawl HTML with "
                       "adversarial distractors, shingle 5 — falsifiable "
                       "recall referee (ground truth + independent "
                       "textbook CPU MinHash)",
        "nominal_bytes": NOMINAL[4], "scaled_bytes": int(docs.size),
        "docs": n_docs, "bases": n_base, "queries": len(queries),
        "distractors": int((klass == 3).sum()),
        "backend": dev.type,
        "card": card_line() if on_card else None,
        "batches": len(batches),
        "recall_at_1_vs_truth": round(recall1, 4),
        "recall_at_5_vs_truth": round(r5 / len(queries), 4) if queries else 1.0,
        "recall_per_class": per_class,
        "recall_target": 0.98,
        "recall_pass": recall1 >= 0.98,
        "referee_queries": len(sub_q),
        "referee_top1_agreement_acc_vs_textbook": round(
            agree / len(sub_q), 4) if sub_q else None,
        "referee_textbook_recall_at_1": round(
            tb_r1 / len(sub_q), 4) if sub_q else None,
        "referee_textbook_sig_seconds": round(tb_dt, 2),
        "kernel_bitexact_cuda_vs_plain": kernel_bitexact,
        "accelerated_sig_GBps_streamed": round(docs.size / acc_dt / 1e9, 4)
        if on_card else None,
        "accelerated_sig_GBps_resident": round(resident_gbps, 4)
        if on_card else None,
    })


def config5(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """4-node-group analogue: the distributed ingest step over a
    (dp=2, sp=2, tp=2) mesh whose eight ranks all sit on one card (or the
    CPU), with the digest all-gather, the sharded index query and the
    pmax.  ``scale`` is recorded only: the shapes are the reference's."""
    dev = resolve_device(device)
    mesh = make_mesh(8, devices=[dev] * 8)  # dp x sp = 4-way node analogue
    rng = np.random.RandomState(5)
    N, L, M = 32, 2 << 10, 256
    stream = rng.randint(0, 256, (8, mesh.shape["sp"], 8192), np.uint8)
    index_sigs = rng.randint(0, 2 ** 32, (M, 64), np.uint64).astype(np.uint32)

    chunks = rng.randint(0, 256, (N, L), np.uint8)
    lens = np.full(N, L, np.int32)

    def run():
        out = distributed_ingest_step(mesh, stream, chunks, lens, index_sigs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    run()  # warm-up (builds the kernels on a first call)
    t0 = time.perf_counter()
    done = 0
    it = 0
    while it < C5_ITERATIONS:
        out = run()
        done += N * L + stream.size
        it += 1
    dt = time.perf_counter() - t0
    cand, digests, sigs, best = (x.cpu().numpy() for x in out)
    on_card = dev.type == "cuda"
    return emit(out_dir, 5, {
        "description": "4-node analogue: dp/sp/tp mesh ingest step with "
                       "digest all-gather + sharded near-dup query + pmax",
        "nominal_bytes": NOMINAL[5], "scaled_bytes": done,
        "scale": scale,
        "mesh": dict(mesh.shape), "iterations": it,
        "backend": dev.type,
        "card": card_line() if on_card else None,
        "seconds": round(dt, 3) if on_card else None,
        "aggregate_GBps": round(done / dt / 1e9, 6) if on_card else None,
        "steps_per_sec": round(it / dt, 3) if on_card else None,
        "note": "the eight ranks of the mesh share one "
                + ("card" if on_card else "CPU") + ": this config checks "
                "that the ranks' stages and the collectives (digest "
                "all-gather, tp sig all-gather, dp pmax) give the right "
                "shapes; "
                + ("the rate is one card's, not a 4-node group's"
                   if on_card else "no rate is reported off the card"),
        "digests_shape": list(digests.shape),
        "sigs_shape": list(sigs.shape),
        "candidates_shape": list(cand.shape),
        "best_shape": list(best.shape),
        "best_sim_finite": bool(np.isfinite(best).all()),
    })


def _kernel_counts() -> dict[str, int]:
    """The launches of config 6's two kernels and the calls of the gear
    kernel's plain twin on a card (which must stay 0), as counted so far."""
    return {"sha1_ragged_cuda.launches": sha1_ragged_cuda.launches,
            "gear_candidates_cuda.launches": gear_candidates_cuda.launches,
            "gear_window.cuda_calls": gear_window.cuda_calls}


def launch_faults(launches: dict[str, int], uploads: int) -> list[str]:
    """Why config 6's card run does not count (empty when it does): each
    negotiated upload launches the SHA-1 kernel once and the gear kernel
    once, or twice where its candidates overflow their slots
    (``gear_cdc.device_cuts``), and no plain twin runs on the card."""
    faults = []
    sha1 = launches["sha1_ragged_cuda.launches"]
    gear = launches["gear_candidates_cuda.launches"]
    if sha1 != uploads:
        faults.append(f"{sha1} SHA-1 launches for {uploads} uploads")
    if not uploads <= gear <= 2 * uploads:
        faults.append(f"{gear} gear launches for {uploads} uploads")
    if launches["gear_window.cuda_calls"]:
        faults.append(f"{launches['gear_window.cuda_calls']} plain gear "
                      "passes on the card")
    return faults


def _config6_corpus(total: int) -> tuple[list[bytes], list[bytes]]:
    """Config 6's 256 KB random blobs and their copies with the trailing
    ~12% rewritten.  Byte for byte the reference's inline generator."""
    blob = 256 << 10
    n_files = max(total // blob, 4)
    rng = np.random.RandomState(6)
    corpus = [rng.randint(0, 256, blob, dtype=np.uint8).tobytes()
              for _ in range(n_files)]
    edited = []
    for data in corpus:
        buf = bytearray(data)
        # rewrite the trailing ~12%: head chunks dedup, tail ships
        cut = len(buf) - len(buf) // 8
        buf[cut:] = rng.randint(0, 256, len(buf) - cut,
                                dtype=np.uint8).tobytes()
        edited.append(bytes(buf))
    return corpus, edited


def config6(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Wire dedup on the ingest edge: negotiated uploads
    (UPLOAD_RECIPE/UPLOAD_CHUNKS) against a real daemon
    (``dedup_mode = cpu``), recording uploaded-vs-saved wire bytes.  The
    client fingerprints each upload on ``device``: on the card one gear
    CDC launch and one SHA-1 launch over the staged payload
    (``client.fingerprint``), on the CPU the NumPy chunker and hashlib.

    Three passes over one corpus of 256 KB blobs:
      1. cold: every chunk is new, the negotiated path ships ~100%;
      2. warm: byte-identical re-upload, ships ~0 (the acceptance bar);
      3. edited: each blob's tail mutated, ships only the changed
         chunks (the realistic mixed case).

    The kernels' launches are counted around the three passes; on the
    card the config writes its artifact and then raises unless each
    upload made one SHA-1 launch and one or two gear launches and no
    plain twin ran (``launch_faults``).
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total = int(NOMINAL[6] * scale)
    corpus, edited = _config6_corpus(total)

    tmp = tempfile.mkdtemp(prefix="fdfs_cfg6_")
    tr, sts, cli = _cluster(tmp, dev)
    try:
        _upload_retry(cli, b"warmup " * 64)
        # Builds the card's kernels before the timed passes.
        fingerprint_buffer(corpus[0], device=dev)

        def run_pass(files):
            sent = 0
            logical = 0
            t0 = time.time()
            for data in files:
                stats = {}
                cli.upload_buffer_dedup(data, ext="bin", min_dup_ratio=0,
                                        stats=stats)
                if stats["fallback"] != "":
                    raise RuntimeError(f"config 6: a negotiated upload "
                                       f"fell back: {stats}")
                sent += stats["bytes_sent"]
                logical += len(data)
            return {"files": len(files), "logical_bytes": logical,
                    "wire_bytes_sent": sent,
                    "bytes_saved": logical - sent,
                    "saved_ratio": round(1 - sent / logical, 4),
                    "seconds": round(time.time() - t0, 3)}

        evidence = {"before": _stats_evidence(cli)}
        before = _kernel_counts()
        cold = run_pass(corpus)
        warm = run_pass(corpus)
        part = run_pass(edited)
        launches = {k: v - before[k] for k, v in _kernel_counts().items()}
        evidence["after"] = _stats_evidence(cli)

        with StorageClient(sts[0].ip, sts[0].port, device=dev) as sc:
            counters = sc.stat()["counters"]
        ingest = {k: v for k, v in counters.items()
                  if k.startswith("ingest.")}
    finally:
        cli.close()
        _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)

    route = ("client fingerprint on the card: gear CDC and SHA-1 kernels"
             if on_card else
             "client fingerprint on the host: NumPy gear CDC and hashlib")
    uploads = cold["files"] + warm["files"] + part["files"]
    art = emit(out_dir, 6, {
        "description": "dedup-aware negotiated uploads: uploaded-vs-saved "
                       "wire bytes on the ingest edge (cold / warm / "
                       f"tail-edited passes; {route})",
        "nominal_bytes": NOMINAL[6],
        "scaled_bytes": sum(len(d) for d in corpus),
        "card": card_line() if on_card else None,
        "cold": cold, "warm": warm, "edited": part,
        "warm_saved_ratio": warm["saved_ratio"],
        "ingest_counters": ingest,
        "kernel_launches": {**launches, "uploads": uploads},
        "phase_wall_s": {"cold": cold["seconds"], "warm": warm["seconds"],
                         "edited": part["seconds"]},
        "daemon_stats": evidence,
        "warm_pass_ok": warm["saved_ratio"] > 0.9,
    })
    faults = launch_faults(launches, uploads) if on_card else []
    if faults:
        raise RuntimeError(f"config 6: the card's route does not count: "
                           f"{'; '.join(faults)}")
    return art


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(int(len(xs) * q), len(xs) - 1)] if xs else 0.0


def config7(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Scrub overhead on foreground IO: upload/download p50/p99 against a
    daemon whose integrity engine is continuously re-verifying the chunk
    store, at scrub_bandwidth_mb_s in {off, 16, unlimited}.

    Per mode: preload a chunk-store corpus, run back-to-back scrub
    passes (scrub_interval_s=1) while timing foreground uploads and
    range downloads, and record the scrubbed chunk/byte throughput so
    the latency deltas can be priced against verify coverage.  No
    kernel runs: plain uploads, the daemon's own CPU dedup and scrub.
    """
    dev = resolve_device(device)
    total = int(NOMINAL[7] * scale)
    blob = 256 << 10
    n_preload = max(total // blob, 8)
    n_ops = max(n_preload // 2, 10)
    rng = np.random.RandomState(7)
    preload = [rng.randint(0, 256, blob, dtype=np.uint8).tobytes()
               for _ in range(n_preload)]

    modes = {"off": "scrub_interval_s = 0",
             "bw16": "scrub_interval_s = 1\nscrub_bandwidth_mb_s = 16",
             "unlimited": "scrub_interval_s = 1\nscrub_bandwidth_mb_s = 0"}
    results = {}
    for name, scrub_conf in modes.items():
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg7_{name}_")
        tr, sts, cli = _cluster(tmp, dev)
        try:
            st = _restart_storage(tmp, tr, sts, scrub_conf)
            _upload_retry(cli, b"warmup " * 64)
            t_pre = time.perf_counter()
            for data in preload:
                cli.upload_buffer(data, ext="bin")
            preload_s = round(time.perf_counter() - t_pre, 3)
            evidence = {"before": _stats_evidence(cli)}
            up_lat, down_lat = [], []
            fid = cli.upload_buffer(preload[0][: blob // 2], ext="bin")
            t_meas = time.perf_counter()
            t_end = time.time() + max(3.0, n_ops * 0.05)
            i = 0
            while time.time() < t_end or i < n_ops:
                payload = rng.randint(0, 256, 64 << 10,
                                      dtype=np.uint8).tobytes()
                t0 = time.time()
                f = cli.upload_buffer(payload, ext="bin")
                up_lat.append(time.time() - t0)
                t0 = time.time()
                cli.download_to_buffer(f)
                down_lat.append(time.time() - t0)
                cli.delete_file(f)
                i += 1
            cli.download_to_buffer(fid)
            measure_s = round(time.perf_counter() - t_meas, 3)
            evidence["after"] = _stats_evidence(cli)
            scrub = cli.scrub_status(st.ip, st.port)
        finally:
            cli.close()
            _stop(tr, sts)
            shutil.rmtree(tmp, ignore_errors=True)
        results[name] = {
            "ops": len(up_lat),
            "upload_p50_ms": round(_pct(up_lat, 0.50) * 1e3, 3),
            "upload_p99_ms": round(_pct(up_lat, 0.99) * 1e3, 3),
            "download_p50_ms": round(_pct(down_lat, 0.50) * 1e3, 3),
            "download_p99_ms": round(_pct(down_lat, 0.99) * 1e3, 3),
            "scrub_passes": scrub["passes"],
            "chunks_verified": scrub["chunks_verified"],
            "bytes_verified": scrub["bytes_verified"],
            "chunks_corrupt": scrub["chunks_corrupt"],
            "phase_wall_s": {"preload": preload_s, "measure": measure_s},
            "daemon_stats": evidence,
        }

    return emit(out_dir, 7, {
        "description": "integrity-engine overhead: foreground upload/"
                       "download p50/p99 with the scrubber off, paced at "
                       "16 MB/s, and unpaced (back-to-back passes); no "
                       "kernel runs (the daemon scrubs on its CPU)",
        "nominal_bytes": NOMINAL[7],
        "scaled_bytes": n_preload * blob,
        "card": card_line() if dev.type == "cuda" else None,
        "modes": results,
        "scrub_verified_ok": results["unlimited"]["chunks_verified"] > 0,
        "no_false_corruption": all(m["chunks_corrupt"] == 0
                                   for m in results.values()),
    })


def config8(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Read path: cold vs warm (cache-hit) download p50/p99 at
    read_cache_mb in {0, 64}, plus a parallel-4 ranged download of one
    large file vs the single-stream path on the same host.  No kernel
    runs: plain uploads and downloads.

    Per cache mode: fresh single-node cluster, upload a corpus of
    chunked 256 KB blobs, then two full read passes: the first is cold
    (nothing in the daemon's hot-chunk cache), the second warm (at
    read_cache_mb=64 every chunk should hit).  Every downloaded payload
    is compared byte for byte against the upload (the zero-wrong-bytes
    column).  Latencies are measured against the storage daemon
    directly so the tracker round trip doesn't blur the cache delta.
    """
    dev = resolve_device(device)
    total = int(NOMINAL[8] * scale)
    blob = 256 << 10
    # The warm pass measures cache hits, so the corpus must fit the
    # 64 MB cache mode with headroom: a corpus bigger than the cache
    # turns the warm pass into a sequential-scan thrash with zero hits.
    n_files = max(min(total, 44 << 20) // blob, 8)
    rng = np.random.RandomState(8)
    corpus = [rng.randint(0, 256, blob, dtype=np.uint8).tobytes()
              for _ in range(n_files)]
    big_bytes = int(max(min(total, 96 << 20), 4 << 20))
    big = rng.randint(0, 256, big_bytes, dtype=np.uint8).tobytes()
    range_bytes = max(big_bytes // 4, 1 << 20)
    host_cpus = os.cpu_count() or 1

    wrong_bytes = 0
    results = {}
    parallel = None
    for name, cache_conf in (("cache0", "read_cache_mb = 0"),
                             ("cache64", "read_cache_mb = 64")):
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg8_{name}_")
        tr, sts, cli = _cluster(tmp, dev)
        try:
            st = _restart_storage(tmp, tr, sts, cache_conf)
            _upload_retry(cli, b"warmup " * 64)
            fids = [cli.upload_buffer(data, ext="bin") for data in corpus]
            evidence = {"before": _stats_evidence(cli)}
            passes = {}
            phase_wall = {}
            with StorageClient(st.ip, st.port, device=dev) as sc:
                for pass_name in ("cold", "warm"):
                    lat = []
                    t_pass = time.perf_counter()
                    for fid, data in zip(fids, corpus):
                        t0 = time.perf_counter()
                        got = sc.download_to_buffer(fid)
                        lat.append(time.perf_counter() - t0)
                        if got != data:
                            wrong_bytes += 1
                    phase_wall[pass_name] = round(
                        time.perf_counter() - t_pass, 3)
                    passes[pass_name] = {
                        "downloads": len(lat),
                        "p50_ms": round(_pct(lat, 0.50) * 1e3, 3),
                        "p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
                        "GBps": round(len(lat) * blob / max(sum(lat), 1e-9)
                                      / 1e9, 4),
                    }
                g = sc.stat()["gauges"]
            evidence["after"] = _stats_evidence(cli)
            results[name] = {
                **passes,
                "phase_wall_s": phase_wall,
                "daemon_stats": evidence,
                "cache_hits": g["cache.hits"],
                "cache_misses": g["cache.misses"],
                "cache_bytes": g["cache.bytes"],
                "warm_speedup_p50": round(
                    passes["cold"]["p50_ms"]
                    / max(passes["warm"]["p50_ms"], 1e-6), 3),
            }

            if name == "cache0":
                # Parallel ranged download of one large uncached file:
                # best of 3 per arm (loopback jitter), single stream vs
                # 4 workers over the replica set.  On a single-CPU host
                # this cannot win (client and daemon share the core), so
                # the artifact records host_cpus.
                fid_big = cli.upload_buffer(big, ext="bin")
                singles, fours = [], []
                for _ in range(3):
                    t0 = time.perf_counter()
                    got = cli.download_ranged(fid_big, parallel=1)
                    singles.append(time.perf_counter() - t0)
                    if got != big:
                        wrong_bytes += 1
                    t0 = time.perf_counter()
                    got = cli.download_ranged(fid_big, parallel=4,
                                              range_bytes=range_bytes)
                    fours.append(time.perf_counter() - t0)
                    if got != big:
                        wrong_bytes += 1
                parallel = {
                    "file_bytes": big_bytes,
                    "range_bytes": range_bytes,
                    "host_cpus": host_cpus,
                    "single_stream_s": round(min(singles), 4),
                    "parallel4_s": round(min(fours), 4),
                    "single_GBps": round(big_bytes / min(singles) / 1e9, 4),
                    "parallel4_GBps": round(big_bytes / min(fours) / 1e9, 4),
                    "speedup": round(min(singles) / min(fours), 3),
                }
                if host_cpus == 1:
                    parallel["note"] = (
                        "single-CPU host: client + daemon share one "
                        "core, so the parallel arm has no spare "
                        "hardware to win with; re-run on a multi-core "
                        "host for the representative number")
        finally:
            cli.close()
            _stop(tr, sts)
            shutil.rmtree(tmp, ignore_errors=True)

    return emit(out_dir, 8, {
        "description": "read-path overhaul: cold vs warm (cache-hit) "
                       "download p50/p99 at read_cache_mb 0/64, and "
                       "parallel-4 ranged download vs single stream; no "
                       "kernel runs (plain uploads and downloads)",
        "nominal_bytes": NOMINAL[8],
        "scaled_bytes": n_files * blob + big_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "host_cpus": host_cpus,
        "modes": results,
        "parallel": parallel,
        "wrong_bytes": wrong_bytes,
        "warm_beats_cold_at_64": (
            results["cache64"]["warm"]["p50_ms"]
            < results["cache64"]["cold"]["p50_ms"]),
        "warm_cache_hits_at_64": results["cache64"]["cache_hits"],
        "parallel4_beats_single": (parallel is not None
                                   and parallel["speedup"] > 1.0),
    })


def config9(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Slab-packed chunk store: a small-file corpus (nominal 100k x 4 KB,
    every payload unique) ingested and downloaded by ``fdfs_load`` with
    slab packing off and on, with the filesystem's inode counts (the
    ``store.inodes_used`` gauge and a files-on-disk walk) and the
    daemon's open fds before and after.  Then a delete-heavy pass on the
    packed store: 80% of the corpus deleted, a kicked scrub pass
    compacts, and the artifact records the share of dead slab bytes
    reclaimed and byte-identical downloads of a sub-corpus uploaded here
    throughout the compaction window.

    ``dedup_chunk_threshold`` is 1 KB, so 4 KB files take the chunked
    path (recipe and content-addressed chunk) in both arms: the
    comparison is the layout alone, a chunk file and a recipe file per
    file against two slab records.  No kernel runs: the daemon dedups on
    its CPU and ``fdfs_load`` is the client.
    """
    dev = resolve_device(device)
    load = _native().load_binary()
    file_bytes = 4096
    n_files = max(int(NOMINAL[9] * scale) // file_bytes, 200)
    threads = min(os.cpu_count() or 1, 4)

    base_conf = ("dedup_chunk_threshold = 1K\nscrub_interval_s = 0"
                 "\nchunk_gc_grace_s = 0")
    arms = {
        "flat": base_conf + "\nslab_chunk_threshold = 0"
                          + "\nslab_recipe_threshold = 0",
        "packed": base_conf + "\nslab_chunk_threshold = 64K"
                            + "\nslab_recipe_threshold = 64K"
                            + "\nslab_size_mb = 64"
                            + "\nslab_compact_min_dead_pct = 25",
    }

    def files_on_disk(base):
        return sum(len(files) for _root, _dirs, files
                   in os.walk(os.path.join(base, "data")))

    def gauges(st):
        with StorageClient(st.ip, st.port, device=dev) as sc:
            return sc.stat()["gauges"]

    def write_ids(path, ids):
        with open(path, "w") as fh:
            fh.write("\n".join(ids) + "\n")

    results = {}
    delete_heavy = None
    wrong_bytes = 0
    for name, keys in arms.items():
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg9_{name}_")
        tr, sts, cli = _cluster(tmp, dev, keys=keys)
        st = sts[0]
        base = os.path.join(tmp, "st0")
        taddr = f"127.0.0.1:{tr.port}"
        try:
            _upload_retry(cli, b"warmup " * 64)
            g0 = gauges(st)
            files_before = files_on_disk(base)
            up_res = os.path.join(tmp, "up.result")
            t0 = time.perf_counter()
            _run_load(load, "upload", taddr, "--small-files", str(n_files),
                      "--file-bytes", str(file_bytes), str(threads), up_res)
            ingest_wall = time.perf_counter() - t0
            ingest = _combine(load, up_res)
            _require(ingest["errors"] == 0, ingest)
            time.sleep(INODE_GAUGE_S)
            g1 = gauges(st)
            files_after = files_on_disk(base)
            fd_count = len(os.listdir(f"/proc/{st.proc.pid}/fd"))
            dl_res = os.path.join(tmp, "down.result")
            _run_load(load, "download", taddr, up_res + ".ids", str(n_files),
                      str(threads), dl_res)
            download = _combine(load, dl_res)
            _require(download["errors"] == 0, download)
            # A short body means lost bytes: every download must return
            # exactly file_bytes.
            _require(download["bytes"] == n_files * file_bytes, download)
            results[name] = {
                "ingest": ingest,
                "ingest_wall_s": round(ingest_wall, 3),
                "download": download,
                "inodes_used_before": g0["store.inodes_used"],
                "inodes_used_after": g1["store.inodes_used"],
                "files_on_disk_before": files_before,
                "files_on_disk_after": files_after,
                "daemon_open_fds_after_ingest": fd_count,
                "slab": {k.split(".", 1)[1]: g1[k] for k in g1
                         if k.startswith("slab.")},
            }

            if name == "packed":
                # The delete-heavy pass and compaction.  A sub-corpus
                # checked here byte for byte pins byte-identity across
                # the compaction window (fdfs_load checks only status
                # and length).
                rng = random.Random(9)
                verified = {}
                for _ in range(100):
                    data = rng.randbytes(file_bytes)
                    verified[cli.upload_buffer(data, ext="bin")] = data
                with open(up_res + ".ids") as fh:
                    ids = [ln.strip() for ln in fh if ln.strip()]
                doomed = ids[:int(len(ids) * 0.8)]
                doomed_path = os.path.join(tmp, "doomed.ids")
                write_ids(doomed_path, doomed)
                del_res = os.path.join(tmp, "del.result")
                _run_load(load, "delete", taddr, doomed_path, str(threads),
                          del_res)
                deleted = _combine(load, del_res)
                dead_before = gauges(st)["slab.bytes_dead"]
                cli.scrub_kick(st.ip, st.port)
                # Byte-identical downloads while the pass compacts.
                deadline = time.perf_counter() + 120
                during_checks = 0
                while time.perf_counter() < deadline:
                    for fid, data in list(verified.items())[:20]:
                        if cli.download_to_buffer(fid) != data:
                            wrong_bytes += 1
                        during_checks += 1
                    gc = gauges(st)
                    if (gc["slab.compactions"] >= 1
                            and gc["slab.bytes_dead"] <= dead_before * 0.2):
                        break
                    time.sleep(0.5)
                gc = gauges(st)
                for fid, data in verified.items():
                    if cli.download_to_buffer(fid) != data:
                        wrong_bytes += 1
                # The surviving fifth of the fdfs_load corpus still
                # serves in full.
                kept = ids[int(len(ids) * 0.8):]
                kept_path = os.path.join(tmp, "kept.ids")
                write_ids(kept_path, kept)
                dl2 = os.path.join(tmp, "down2.result")
                _run_load(load, "download", taddr, kept_path, str(len(kept)),
                          str(threads), dl2)
                after_dl = _combine(load, dl2)
                _require(after_dl["errors"] == 0, after_dl)
                _require(after_dl["bytes"] == len(kept) * file_bytes,
                         after_dl)
                delete_heavy = {
                    "deleted_files": len(doomed),
                    "delete_errors": deleted["errors"],
                    "dead_bytes_before_compaction": dead_before,
                    "dead_bytes_after_compaction": gc["slab.bytes_dead"],
                    "reclaim_pct": round(
                        100.0 * (1 - gc["slab.bytes_dead"]
                                 / max(dead_before, 1)), 2),
                    "compactions": gc["slab.compactions"],
                    "compacted_bytes": gc["slab.compacted_bytes"],
                    "slab_files_after": gc["slab.files"],
                    "byte_checks_during_compaction": during_checks,
                    "survivor_download": after_dl,
                }
        finally:
            cli.close()
            _stop(tr, sts)
            shutil.rmtree(tmp, ignore_errors=True)

    flat, packed = results["flat"], results["packed"]
    flat_inodes = flat["inodes_used_after"] - flat["inodes_used_before"]
    packed_inodes = packed["inodes_used_after"] - packed["inodes_used_before"]
    flat_p50 = flat["ingest"]["lat_p50_us"]
    packed_p50 = packed["ingest"]["lat_p50_us"]
    return emit(out_dir, 9, {
        "description": "slab-packed chunk store: small-file corpus "
                       "(unique 4 KB files) ingested + downloaded with "
                       "slab packing off vs on, inode/fd counts "
                       "embedded, plus a delete-heavy pass with paced "
                       "online compaction and byte-identical downloads "
                       "throughout",
        "nominal_bytes": NOMINAL[9],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "file_bytes": file_bytes,
        "threads": threads,
        "host_cpus": os.cpu_count() or 1,
        "modes": results,
        "inode_delta_flat": flat_inodes,
        "inode_delta_packed": packed_inodes,
        "files_on_disk_delta_flat": (flat["files_on_disk_after"]
                                     - flat["files_on_disk_before"]),
        "files_on_disk_delta_packed": (packed["files_on_disk_after"]
                                       - packed["files_on_disk_before"]),
        "inode_ratio": round(flat_inodes / max(packed_inodes, 1), 2),
        "ingest_p50_packed_vs_flat": round(packed_p50 / max(flat_p50, 1), 3),
        "delete_heavy": delete_heavy,
        "wrong_bytes": wrong_bytes,
        "inode_win_10x": flat_inodes >= 10 * max(packed_inodes, 1),
        "ingest_p50_no_worse": packed_p50 <= flat_p50,
        "compaction_reclaims_80pct": (delete_heavy is not None
                                      and delete_heavy["reclaim_pct"]
                                      >= 80.0),
    })


def config10(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Multi-group scale-out: the same open-loop zipfian download load
    offered to a one-group and a three-group cluster, the tracker in
    placement mode (``store_lookup = 3``; the keyless preload
    round-robins, so the corpus spreads evenly).  The offered rate is
    calibrated once, 70% of the one-group arm's closed-loop QPS, and
    replayed open-loop (``fdfs_load --open-loop --rate R``) against both
    arms, so latency counts from the scheduled instant: an arm that
    cannot absorb the rate shows its backlog in the percentiles instead
    of throttling the generator.  A last phase drains group3 and clocks
    the rebalance migrator emptying it: files and bytes moved, wall time
    and the pace against its bandwidth budget.  The storages keep
    ``dedup_mode = none``, as the reference's; no kernel runs.
    """
    dev = resolve_device(device)
    native = _native()
    storaged, trackerd, _ = native.native_binaries()
    load = native.load_binary()
    file_bytes = 64 * 1024
    n_files = max(int(NOMINAL[10] * scale) // file_bytes, 60)
    n_ops = n_files * 2
    threads = min(os.cpu_count() or 1, 8)
    zipf_s = 1.1

    arms = {"one_group": ["group1"],
            "three_groups": ["group1", "group2", "group3"]}
    results = {}
    offered_rate = 0.0
    for name, groups in arms.items():
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg10_{name}_")
        tr = native.start_tracker(trackerd, os.path.join(tmp, "tr"),
                                  store_lookup=3)
        taddr = f"127.0.0.1:{tr.port}"
        storages = []
        cli = None
        try:
            for g in groups:
                storages.append(native.start_storage(
                    storaged, os.path.join(tmp, g), group=g,
                    trackers=[taddr], extra=HB))
            cli = FdfsClient([taddr], device=dev)
            _upload_retry(cli, b"warmup " * 64)
            up_res = os.path.join(tmp, "up.result")
            _run_load(load, "upload", taddr, str(n_files), str(file_bytes),
                      str(threads), up_res)
            preload = _combine(load, up_res)
            _require(preload["errors"] == 0, preload)
            with open(up_res + ".ids") as fh:
                ids = [ln.strip() for ln in fh if ln.strip()]
            spread = {}
            for fid in ids:
                g = fid.split("/", 1)[0]
                spread[g] = spread.get(g, 0) + 1
            if name == "one_group":
                # Calibrate the offered rate once, on the small arm's
                # closed-loop capacity; both arms get the same rate.
                cal_res = os.path.join(tmp, "cal.result")
                _run_load(load, "download", taddr, up_res + ".ids",
                          str(n_ops), str(threads), cal_res,
                          "--zipf", str(zipf_s))
                cal = _combine(load, cal_res)
                _require(cal["errors"] == 0, cal)
                offered_rate = max(round(cal["qps"] * 0.7, 1), 1.0)
            dl_res = os.path.join(tmp, "down.result")
            _run_load(load, "download", taddr, up_res + ".ids", str(n_ops),
                      str(threads), dl_res, "--zipf", str(zipf_s),
                      "--open-loop", "--rate", str(offered_rate))
            open_dl = _combine(load, dl_res)
            _require(open_dl["errors"] == 0, open_dl)
            results[name] = {
                "groups": len(groups),
                "preload": preload,
                "group_spread": spread,
                "open_download": open_dl,
            }
            if name == "three_groups":
                # Drain pace: retire one group and clock the migrator
                # emptying it (budget: rebalance_bandwidth_mb_s, default
                # 8; the wall also carries beat and retire latency, so
                # the pace reads as a floor).
                t0 = time.perf_counter()
                cli.group_drain("group3")
                deadline = t0 + 600
                while time.perf_counter() < deadline:
                    table = cli.query_placement()
                    if any(g["group"] == "group3" and g["state"] == 2
                           for g in table["groups"]):
                        break
                    time.sleep(0.5)
                wall = time.perf_counter() - t0
                cs = cli.cluster_stat("group3")
                st = cs["groups"][0]["storages"][0]["stats"]
                results[name]["drain"] = {
                    "files_moved": st["rebalance_files_moved"],
                    "bytes_moved": st["rebalance_bytes_moved"],
                    "errors": st["rebalance_errors"],
                    "done": st["rebalance_done"],
                    "wall_s": round(wall, 2),
                    "pace_mb_s": round(st["rebalance_bytes_moved"] / 1e6
                                       / max(wall, 1e-9), 2),
                    "bandwidth_budget_mb_s": 8,
                }
        finally:
            if cli is not None:
                cli.close()
            _stop(tr, storages)
            shutil.rmtree(tmp, ignore_errors=True)

    one, three = results["one_group"], results["three_groups"]
    spread3 = three["group_spread"]
    return emit(out_dir, 10, {
        "description": "multi-group scale-out: identical open-loop "
                       "zipfian download load (rate = 70% of the "
                       "1-group closed-loop QPS) against 1 vs 3 groups "
                       "under a placement-mode tracker; latency counts "
                       "from the scheduled instant, so falling behind "
                       "the offered rate shows up in the percentiles",
        "nominal_bytes": NOMINAL[10],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "file_bytes": file_bytes,
        "open_loop_ops": n_ops,
        "threads": threads,
        "zipf_s": zipf_s,
        "offered_rate_qps": offered_rate,
        "host_cpus": os.cpu_count() or 1,
        "arms": results,
        "p99_three_vs_one": round(
            three["open_download"]["lat_p99_us"]
            / max(one["open_download"]["lat_p99_us"], 1), 3),
        "zero_errors": all(
            r["preload"]["errors"] == 0 and r["open_download"]["errors"] == 0
            for r in results.values()),
        "three_group_spread_within_10pct": all(
            abs(spread3.get(g, 0) / max(n_files, 1) - 1 / 3) <= 0.10
            for g in ("group1", "group2", "group3")),
        "open_loop_rate_met_3g": (
            three["open_download"]["qps"] >= 0.85 * offered_rate),
        "drain_relocated_all": (
            three["drain"]["done"] == 1
            and three["drain"]["errors"] == 0
            and three["drain"]["files_moved"] >= spread3.get("group3", 0)),
    })


def _wait_for(cond, timeout=180):
    """``cond()``'s first true value within ``timeout`` seconds, else its
    value at the deadline."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.3)
    return cond()


def config11(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Erasure-coded cold tier: what the RS(3, 2) tier saves and what it
    costs.  A two-member group ingests an incompressible corpus under 2x
    replication, then both members take an ``EC_KICK``: cold chunks
    stripe into RS(3+2), and the verify-then-release handover drops the
    replica copies.  Physical over logical bytes fall from ~2x to at
    most (k+m)/k + 5% while downloads stay byte-identical; the EC
    phase's p50/p99 prices the decode path beside the replicated one.  A
    second, single-node phase measures reconstruction: every stripe
    loses m = 2 shard files and a scrub pass rebuilds them from parity,
    once unpaced (``ec_bandwidth_mb_s = 0``) and once against a 2 MB/s
    budget, which the paced run must not exceed.

    Physical bytes are the live payload inventory (flat chunk files,
    live slab records, EC shard and manifest files): dead slab slots are
    left out, since the compactor reclaims them later.  No kernel runs:
    the daemons encode and rebuild on their CPUs.
    """
    dev = resolve_device(device)
    scan = _native().harness  # the store scanners of tests/harness.py
    file_bytes = 256 * 1024
    n_files = max(int(NOMINAL[11] * scale) // file_bytes, 12)
    ec_k, ec_m = 3, 2
    pace_budget_mb_s = 2
    ec_conf = ("scrub_interval_s = 0\nchunk_gc_grace_s = 1"
               f"\nec_k = {ec_k}\nec_m = {ec_m}\nec_demote_age_s = 86400")

    def physical_bytes(base):
        total = sum(os.path.getsize(f) for f in scan.chunk_files(base))
        total += sum(r["payload_len"] for r in scan.slab_records(base)
                     if r["kind"] == 1 and not r["dead"])
        for st in scan.stripe_files(base).values():
            total += sum(os.path.getsize(p) for p in st["shards"].values())
            total += os.path.getsize(st["manifest"])
        return total

    def timed_downloads(cli, fids, blobs, n_ops):
        lats, wrong = [], 0
        rnd = random.Random(11)
        t0 = time.perf_counter()
        for _ in range(n_ops):
            fid = rnd.choice(fids)
            s = time.perf_counter()
            got = cli.download_to_buffer(fid)
            lats.append((time.perf_counter() - s) * 1e6)
            if got != blobs[fid]:
                wrong += 1
        wall = time.perf_counter() - t0
        lats.sort()
        return {"ops": n_ops, "wrong": wrong,
                "qps": round(n_ops / max(wall, 1e-9), 1),
                "lat_p50_us": round(lats[len(lats) // 2], 1),
                "lat_p99_us": round(lats[min(len(lats) - 1,
                                             int(len(lats) * 0.99))], 1)}

    # -- phase 1: replicated, then EC, on a two-member group --------------
    tmp = tempfile.mkdtemp(prefix="fdfs_cfg11_group_")
    tr, storages, cli = _cluster(tmp, dev, n_storages=2, keys=ec_conf,
                                 first_ip=80)
    bases = [os.path.join(tmp, f"st{i}") for i in range(2)]
    rnd = random.Random(16)
    try:
        blobs = {}
        t0 = time.perf_counter()
        for _ in range(n_files):
            data = rnd.randbytes(file_bytes)
            blobs[_upload_retry(cli, data, ext="bin")] = data
        ingest_s = time.perf_counter() - t0
        fids = list(blobs)
        logical = n_files * file_bytes
        # Replication done: both members hold every chunk payload.
        _require(_wait_for(
            lambda: all(scan.chunk_digests(b) for b in bases)
            and len(scan.chunk_digests(bases[0]))
            == len(scan.chunk_digests(bases[1]))),
            "both members hold every chunk")
        inv = set(scan.chunk_digests(bases[0]))
        replicated_phys = sum(physical_bytes(b) for b in bases)
        n_ops = min(len(fids) * 4, 200)
        replicated_dl = timed_downloads(cli, fids, blobs, n_ops)

        for s in storages:
            cli.ec_kick(s.ip, s.port)

        def demoted():
            maps = [scan.chunk_digests(b) for b in bases]
            stats = [cli.ec_status(s.ip, s.port) for s in storages]
            if any(maps):
                return None  # replicas or payloads still resident
            if sum(st["demoted_chunks"] for st in stats) < len(inv):
                return None
            return stats
        stats = _wait_for(demoted)
        _require(stats, [cli.ec_status(s.ip, s.port) for s in storages])
        ec_phys = sum(physical_bytes(b) for b in bases)
        ec_dl = timed_downloads(cli, fids, blobs, n_ops)
        group_result = {
            "members": 2,
            "files": n_files,
            "logical_bytes": logical,
            "ingest_mb_s": round(logical / 1e6 / max(ingest_s, 1e-9), 2),
            "replicated_physical_bytes": replicated_phys,
            "replicated_physical_over_logical": round(
                replicated_phys / logical, 3),
            "ec_physical_bytes": ec_phys,
            "ec_physical_over_logical": round(ec_phys / logical, 3),
            "released_chunks": sum(st["released_chunks"] for st in stats),
            "remote_reads_after_dl": sum(
                cli.ec_status(s.ip, s.port)["remote_reads"]
                for s in storages),
            "replicated_download": replicated_dl,
            "ec_download": ec_dl,
        }
    finally:
        cli.close()
        _stop(tr, storages)
        shutil.rmtree(tmp, ignore_errors=True)

    # -- phase 2: reconstruction MB/s, unpaced and paced ------------------
    recon = {}
    for arm, budget in (("unpaced", 0), ("paced", pace_budget_mb_s)):
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg11_{arm}_")
        tr, sts, cli = _cluster(
            tmp, dev, keys=ec_conf + f"\nec_bandwidth_mb_s = {budget}")
        st = sts[0]
        base = os.path.join(tmp, "st0")
        try:
            blobs = {}
            for _ in range(n_files):
                data = rnd.randbytes(file_bytes)
                blobs[_upload_retry(cli, data, ext="bin")] = data
            cli.ec_kick(st.ip, st.port)
            # Demotion settles when every chunk payload has left the
            # flat and slab tiers (the corpus spans several 4 MB stripe
            # batches: "stripes >= 1" would catch it mid-demotion).
            _require(_wait_for(
                lambda: cli.ec_status(st.ip, st.port)["stripes"] >= 1
                and not scan.chunk_digests(base)), "every chunk demoted")
            # Kill m shards of every stripe, then clock one repair pass.
            full = {sid: sorted(s["shards"])
                    for sid, s in scan.stripe_files(base).items()}
            for sid, idxs in full.items():
                for idx in idxs[:ec_m]:
                    os.unlink(scan.stripe_files(base)[sid]["shards"][idx])
            before = cli.ec_status(st.ip, st.port)
            passes0 = cli.scrub_status(st.ip, st.port)["passes"]
            t0 = time.perf_counter()
            cli.scrub_kick(st.ip, st.port)
            # Clock the whole repair pass, not the first file back: the
            # token bucket pays its debt after each stripe's shards are
            # durable, so files alone would credit the paced arm with
            # the unpaced rate.
            _require(_wait_for(lambda: (
                cli.scrub_status(st.ip, st.port)["passes"] > passes0
                and all(sorted(s["shards"]) == full[sid]
                        for sid, s in scan.stripe_files(base).items()))),
                "every shard rebuilt")
            wall = time.perf_counter() - t0
            after = cli.ec_status(st.ip, st.port)
            rebuilt = (after["reconstructed_bytes"]
                       - before["reconstructed_bytes"])
            wrong = sum(1 for fid, want in blobs.items()
                        if cli.download_to_buffer(fid) != want)
            recon[arm] = {
                "bandwidth_budget_mb_s": budget,
                "stripes": len(full),
                "shards_rebuilt": (after["reconstructed_shards"]
                                   - before["reconstructed_shards"]),
                "rebuilt_bytes": rebuilt,
                "wall_s": round(wall, 3),
                "rebuild_mb_s": round(rebuilt / 1e6 / max(wall, 1e-9), 2),
                "repair_fallback_chunks": after["repair_fallback_chunks"],
                "wrong_bytes_after": wrong,
            }
        finally:
            cli.close()
            _stop(tr, sts)
            shutil.rmtree(tmp, ignore_errors=True)

    ec_overhead_bound = (ec_k + ec_m) / ec_k * 1.05
    replicated_dl = group_result["replicated_download"]
    ec_dl = group_result["ec_download"]
    return emit(out_dir, 11, {
        "description": "erasure-coded cold tier: 2x-replicated corpus "
                       "demoted into RS(3+2) stripes with group-wide "
                       "replica release (physical/logical vs the "
                       "replica multiple, download p50/p99 both ways), "
                       "plus kill-m-shards reconstruction throughput "
                       "paced vs unpaced",
        "nominal_bytes": NOMINAL[11],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "file_bytes": file_bytes,
        "ec_k": ec_k,
        "ec_m": ec_m,
        "host_cpus": os.cpu_count() or 1,
        "group": group_result,
        "reconstruction": recon,
        "ec_overhead_bound": round(ec_overhead_bound, 3),
        "efficiency_pass": (
            group_result["ec_physical_over_logical"] <= ec_overhead_bound
            and group_result["ec_physical_over_logical"]
            < group_result["replicated_physical_over_logical"]),
        "replication_near_2x": (
            1.8 <= group_result["replicated_physical_over_logical"] <= 2.3),
        "zero_wrong_bytes": (
            replicated_dl["wrong"] == 0 and ec_dl["wrong"] == 0
            and all(r["wrong_bytes_after"] == 0 for r in recon.values())),
        "reconstruct_from_parity_only": all(
            r["repair_fallback_chunks"] == 0 for r in recon.values()),
        "paced_within_budget": (
            recon["paced"]["rebuild_mb_s"]
            <= pace_budget_mb_s * 1.25 + 0.5),
        "pacing_effective": (
            recon["unpaced"]["rebuild_mb_s"]
            > recon["paced"]["rebuild_mb_s"]),
        "ec_download_p99_vs_replicated": round(
            ec_dl["lat_p99_us"] / max(replicated_dl["lat_p99_us"], 1), 3),
    })


def config12(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Serving-edge concurrency: the same open-loop download load offered
    to a 1-reactor and a 4-reactor storage (SO_REUSEPORT sharded
    accept), each driven through one shared storage connection
    (``fdfs_load --conns 1``) and through a pool (``--conns
    <threads>``).  The offered rates are calibrated once, 40% and 70% of
    the 1-reactor arm's closed-loop QPS, and replayed open-loop against
    every (reactors x client) cell, so schedule lateness lands in the
    percentiles.  The corpus is 256 KB files in 4 KB chunks with the
    read cache off, so every download walks the cold recipe path and
    the vectored read batcher must show ``dio.preadv_spans`` above
    ``dio.preadv_batches``.  Beside the latency table each arm records:
    64 held sockets against the per-reactor ``nio.conns.<i>`` gauges
    (every reactor within 2x of the mean, none idle); ``fdfs_load``'s
    pool evidence (``conns_peak`` 1 under ``--conns 1``); a byte-identity
    sweep through the port's parallel ranged downloader under a 2-conn
    endpoint cap (no wrong byte, no single-stream fallback); and a
    flamegraph, ``python -m fastdfs_tpu_torch.cli --device <device>
    profile``'s folded stacks captured mid-load, written next to the
    artifact as ``config12_reactors{1,4}.folded`` with the live conns
    per reactor sampled in the capture window.  No kernel runs: the
    storage dedups on its CPU and ``fdfs_load`` is the client.

    One deliberate difference from the reference: the flamegraph's load
    starts when the CLI has armed the sampler, not 0.5 s before the CLI
    starts.  The port's CLI imports torch before it arms the sampler,
    which on an H100's host takes longer than the ~8 s load (this
    config prints the CLI's wall time), so with the reference's order
    every capture there fell after the load, and some held no sample.
    """
    dev = resolve_device(device)
    load = _native().load_binary()
    file_bytes = 256 * 1024
    n_files = max(int(NOMINAL[12] * scale) // file_bytes, 24)
    n_ops = n_files * 4
    # Load workers are blocking network clients, not CPU burners: at
    # least 4 even on a small host, or the pooled arm (--conns
    # <threads>) degenerates into the single-conn arm.
    threads = min(max(os.cpu_count() or 1, 4), 8)
    reactors_hi = 4
    burst_conns = 64
    profile_hz = 97
    profile_seconds = 3
    daemon_keys = ("dedup_chunk_threshold = 4K"   # 256 KB: ~64 chunks
                   "\nread_cache_mb = 0"          # the cold path
                   "\nprofile_max_hz = 200")

    def daemon_stat(st):
        with StorageClient(st.ip, st.port, device=dev) as sc:
            return sc.stat()

    def reactor_family(gauges, prefix):
        # nio.conns.0, nio.conns.1, ... -> {0: v0, 1: v1, ...}
        out = {}
        for name, v in gauges.items():
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                out[int(name[len(prefix):])] = v
        return out

    os.makedirs(out_dir, exist_ok=True)
    results = {}
    rates: list[float] = []
    budget_ok = True
    wrong_bytes = 0
    for reactors in (1, reactors_hi):
        arm = f"reactors{reactors}"
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg12_{arm}_")
        tr, sts, cli = _cluster(
            tmp, dev, keys=daemon_keys + f"\nwork_threads = {reactors}")
        st = sts[0]
        taddr = f"127.0.0.1:{tr.port}"
        try:
            _upload_retry(cli, b"warmup " * 64)
            up_res = os.path.join(tmp, "up.result")
            _run_load(load, "upload", taddr, str(n_files), str(file_bytes),
                      str(threads), up_res)
            preload = _combine(load, up_res)
            _require(preload["errors"] == 0, preload)
            ids_path = up_res + ".ids"
            if not rates:
                # Calibrate once, on the 1-reactor arm's closed-loop
                # capacity; every cell then replays the same rates.
                cal_res = os.path.join(tmp, "cal.result")
                _run_load(load, "download", taddr, ids_path, str(n_ops),
                          str(threads), cal_res)
                cal = _combine(load, cal_res)
                _require(cal["errors"] == 0, cal)
                rates = [max(round(cal["qps"] * f, 1), 1.0)
                         for f in (0.4, 0.7)]
            clients = {}
            for client_name, budget in (("single_conn", 1),
                                        ("multiplexed", threads)):
                sweep = []
                for rate in rates:
                    res = os.path.join(tmp, f"{client_name}_{rate}.result")
                    conns = _run_load(load, "download", taddr, ids_path,
                                      str(n_ops), str(threads), res,
                                      "--conns", str(budget),
                                      "--open-loop", "--rate", str(rate))
                    agg = _combine(load, res)
                    _require(agg["errors"] == 0, agg)
                    # --conns 1 serializes the storage edge: the pool
                    # must never open a second conn, whatever the rate.
                    budget_ok = budget_ok and (
                        conns is not None
                        and conns["conns_budget"] == budget
                        and conns["conns_peak"] <= budget
                        and (budget != 1 or conns["conns_peak"] == 1))
                    sweep.append({"offered_rate_qps": rate,
                                  "qps": agg["qps"],
                                  "lat_p50_us": agg["lat_p50_us"],
                                  "lat_p99_us": agg["lat_p99_us"],
                                  "errors": agg["errors"],
                                  "pool": conns})
                clients[client_name] = sweep

            # Byte identity through the pooled ranged client: the
            # parallel downloader under a 2-conn endpoint cap must give
            # exactly the single-stream bytes, with no single-stream
            # fallback (the cap waits, it never breaks the ranged plan).
            ver = FdfsClient([taddr], parallel_downloads=4,
                             download_range_bytes=64 * 1024,
                             max_conns_per_endpoint=2, device=dev)
            with open(ids_path) as fh:
                ids = [ln.strip() for ln in fh if ln.strip()]
            arm_wrong = 0
            for fid in ids[:min(len(ids), 24)]:
                base = cli.download_to_buffer(fid)
                if (len(base) != file_bytes
                        or ver.download_to_buffer(fid) != base):
                    arm_wrong += 1
            ranged_fallbacks = ver.stats()["ranged_fallback_single"]
            ver.close()
            wrong_bytes += arm_wrong

            # Accept-spread probe: hold a burst of raw sockets and read
            # the per-reactor live-conn gauges.  With SO_REUSEPORT the
            # kernel hashes the 4-tuple, so "within 2x of the mean and
            # no reactor idle" is the fair-spread bar.
            probes = [socket.create_connection((st.ip, st.port), timeout=10)
                      for _ in range(burst_conns)]
            try:
                time.sleep(0.5)  # fallback-mode adoption is a Post
                g = daemon_stat(st)["gauges"]
            finally:
                for s in probes:
                    s.close()
            conns_per = reactor_family(g, "nio.conns.")
            accepts_per = reactor_family(g, "nio.accepts.")
            vals = list(conns_per.values())
            mean = sum(vals) / max(len(vals), 1)
            spread_ok = (len(vals) == reactors
                         and all(v > 0 for v in vals)
                         and max(vals) <= 2 * mean)

            # Flamegraph: arm the in-daemon sampler through the port's
            # CLI with an open-loop run in flight, and sample the live
            # conns per reactor inside the capture window.  The load
            # starts when the CLI reports the sampler armed (the
            # docstring says why).
            flame_rate = rates[-1]
            flame_ops = max(int(flame_rate * 8), n_ops)
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            t0 = time.perf_counter()
            # Unbuffered, so reading up to the "armed" line takes no byte
            # past it from communicate().
            prof = subprocess.Popen(
                [sys.executable, "-m", "fastdfs_tpu_torch.cli",
                 "--device", dev.type, "profile",
                 taddr, f"{st.ip}:{st.port}",
                 "--hz", str(profile_hz),
                 "--seconds", str(profile_seconds)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                bufsize=0)
            # The reference's 120 s limit on the CLI, "armed" line included.
            watchdog = threading.Timer(120, prof.kill)
            watchdog.start()
            bg = None
            err_head = b""
            try:
                for line in iter(prof.stderr.readline, b""):
                    err_head += line
                    if line.startswith(b"armed "):
                        bg = subprocess.Popen(
                            [load, "download", taddr, ids_path,
                             str(flame_ops), str(threads),
                             os.path.join(tmp, "flame.result"),
                             "--conns", str(threads),
                             "--open-loop", "--rate", str(flame_rate)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
                        break
                out, err = prof.communicate()
                prof_wall = time.perf_counter() - t0
                # The open-loop schedule keeps the load alive past the
                # capture deadline, so this sample still sees it.
                disp = reactor_family(daemon_stat(st)["gauges"],
                                      "nio.conns.")
            finally:
                watchdog.cancel()
                if prof.poll() is None:
                    prof.kill()
                    prof.wait()
                if bg is not None:
                    bg.wait(timeout=600)
            _require(prof.returncode == 0 and bg is not None,
                     (err_head + err).decode(errors="replace"))
            _require(bg.returncode == 0,
                     f"the flamegraph's load exited {bg.returncode}")
            folded = out.decode()
            flame_name = f"config12_{arm}.folded"
            with open(os.path.join(out_dir, flame_name), "w") as fh:
                fh.write(folded)
            samples = sum(int(ln.rsplit(" ", 1)[1])
                          for ln in folded.splitlines() if " " in ln)
            print(f"config 12 {arm}: the profile CLI took {prof_wall:.2f} s "
                  f"for a {profile_seconds} s capture at {profile_hz} Hz, "
                  f"{samples} samples; live conns per reactor {disp}",
                  flush=True)

            ctr = daemon_stat(st)["counters"]
            results[arm] = {
                "reactors": reactors,
                "reuseport_active": g.get("nio.reuseport_active", 0),
                "preload": preload,
                "clients": clients,
                "ranged_verify": {
                    "files": min(len(ids), 24),
                    "wrong": arm_wrong,
                    "ranged_fallbacks": ranged_fallbacks,
                },
                "accept_burst": {
                    "held_sockets": burst_conns,
                    "conns_per_reactor": conns_per,
                    "accepts_per_reactor": accepts_per,
                    "spread_within_2x": spread_ok,
                },
                "preadv": {
                    "batches": ctr.get("dio.preadv_batches", 0),
                    "spans": ctr.get("dio.preadv_spans", 0),
                    "spans_per_batch": round(
                        ctr.get("dio.preadv_spans", 0)
                        / max(ctr.get("dio.preadv_batches", 0), 1), 2),
                },
                "flamegraph": {
                    "folded_file": flame_name,
                    "hz": profile_hz,
                    "seconds": profile_seconds,
                    "samples": samples,
                    "stacks": len(folded.splitlines()),
                    "capture_note": (
                        f"captured mid-load at {flame_rate} q/s "
                        f"(--conns {threads}); live conns per reactor "
                        f"sampled inside the window: {disp}"),
                },
            }
        finally:
            cli.close()
            _stop(tr, sts)
            shutil.rmtree(tmp, ignore_errors=True)

    hi = results[f"reactors{reactors_hi}"]
    lo = results["reactors1"]
    top = len(rates) - 1
    return emit(out_dir, 12, {
        "description": "serving-edge concurrency: open-loop download "
                       "p99 vs offered rate (40%/70% of the 1-reactor "
                       "closed-loop QPS) across 1 vs 4 accept reactors "
                       "and single vs multiplexed client connections, "
                       "with accept-spread, preadv-coalescing, "
                       "byte-identity, and mid-load flamegraph "
                       "evidence per arm",
        "nominal_bytes": NOMINAL[12],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "file_bytes": file_bytes,
        "open_loop_ops": n_ops,
        "threads": threads,
        "host_cpus": os.cpu_count() or 1,
        "offered_rates_qps": rates,
        "arms": results,
        "zero_errors": all(
            cell["errors"] == 0
            for r in results.values()
            for sweep in r["clients"].values()
            for cell in sweep),
        "wrong_bytes": wrong_bytes,
        "conn_budget_honored": budget_ok,
        "accept_spread_within_2x": hi["accept_burst"]["spread_within_2x"],
        "preadv_spans_exceed_batches": all(
            r["preadv"]["spans"] > r["preadv"]["batches"] > 0
            for r in results.values()),
        "p99_multiplexed_vs_single_4r": round(
            hi["clients"]["multiplexed"][top]["lat_p99_us"]
            / max(hi["clients"]["single_conn"][top]["lat_p99_us"], 1), 3),
        "p99_4r_vs_1r_multiplexed": round(
            hi["clients"]["multiplexed"][top]["lat_p99_us"]
            / max(lo["clients"]["multiplexed"][top]["lat_p99_us"], 1), 3),
    })


def config13(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """SLO-driven admission control: the same open-loop download mix
    (interactive, normal and background through ``--priority-mix``)
    offered at 1.7x the calibrated closed-loop capacity to a baseline
    storage (``admission_control = 0``) and to one with admission on,
    whose ``request_p99_ms`` SLO threshold is half the server-side
    saturation p99 (read off the daemon's own
    ``op.download_file.latency_us`` histogram after the closed-loop
    calibration; the client's number includes tracker RPCs and schedule
    lateness that the SLO never sees).  The corpus is 1 MB files in 4 KB
    chunks with the read cache off, so each download is ~256 cold chunk
    reads and the storage, not the driver, is the bottleneck defended.
    Open-loop latency counts from the scheduled instant, so when the
    baseline falls behind the offered rate the backlog lands in its
    percentiles: the collapse that the ladder exists to prevent.  The
    artifact records no shed at half capacity on the admission arm;
    under overload, sheds that never touch the interactive class and
    prefer background to normal; per-class admitted-only percentiles
    from ``fdfs_load combine``; admitted goodput beside the baseline's;
    the ladder's lifetime gauges; and the p99 collapse ratio (baseline
    overall p99 over the admission arm's interactive p99 at the same
    offered rate).  No kernel runs: the storage dedups on its CPU and
    ``fdfs_load`` is the client.
    """
    dev = resolve_device(device)
    load = _native().load_binary()
    file_bytes = 1 << 20
    n_files = max(int(NOMINAL[13] * scale) // file_bytes, 12)
    # Enough blocking load workers that the saturated closed-loop p99
    # (queueing across the in-flight cap) sits well above the light-load
    # p99: the band the SLO threshold is planted in.
    threads = 16
    overload_factor = 1.7
    half_factor = 0.5
    overload_seconds = 15
    half_seconds = 6
    mix = "interactive:1:0.4,normal:2:0.3,background:4:0.3"
    # 4 KB-chunked cold reads (cache off) keep per-op service real, and
    # one reactor keeps the capacity low enough to overload from a
    # single driver; 1 s SLO and metrics ticks let the ladder move a
    # rung a second instead of every five.
    base_keys = ("slo_eval_interval_s = 1"
                 "\ndedup_chunk_threshold = 4K"
                 "\nread_cache_mb = 0"
                 "\nwork_threads = 1")

    def admitted_goodput(agg):
        done = sum(c["admitted"] for c in agg["by_class"].values())
        return round(done / max(agg["wall_seconds"], 1e-9), 1)

    def cell(agg):
        return {"ops": agg["ops"], "qps": agg["qps"],
                "goodput_qps": admitted_goodput(agg),
                "shed": agg["shed"],
                "non_shed_errors": agg["errors"] - agg["shed"],
                "lat_p50_us": agg["lat_p50_us"],
                "lat_p99_us": agg["lat_p99_us"],
                "by_class": agg["by_class"]}

    def preload(tmp, taddr, cli):
        _upload_retry(cli, b"warmup " * 64)
        up_res = os.path.join(tmp, "up.result")
        _run_load(load, "upload", taddr, str(n_files), str(file_bytes),
                  str(threads), up_res)
        up = _combine(load, up_res)
        _require(up["errors"] == 0, up)
        return up_res + ".ids"

    def open_loop(tmp, taddr, ids_path, rate, seconds, tag):
        res = os.path.join(tmp, f"{tag}.result")
        n_ops = max(int(rate * seconds), 120)
        _run_load(load, "download", taddr, ids_path, str(n_ops),
                  str(threads), res, "--open-loop", "--rate", str(rate),
                  "--priority-mix", mix)
        return _combine(load, res)

    def admission_gauges(st):
        with StorageClient(st.ip, st.port, device=dev) as sc:
            g = sc.stat()["gauges"]
        return {k: v for k, v in g.items() if k.startswith("admission.")}

    os.makedirs(out_dir, exist_ok=True)
    results = {}

    # -- baseline arm: calibrate capacity, then collapse it ---------------
    tmp = tempfile.mkdtemp(prefix="fdfs_cfg13_baseline_")
    tr, sts, cli = _cluster(tmp, dev,
                            keys=base_keys + "\nadmission_control = 0")
    st = sts[0]
    taddr = f"127.0.0.1:{tr.port}"
    try:
        ids_path = preload(tmp, taddr, cli)
        cal_res = os.path.join(tmp, "cal.result")
        _run_load(load, "download", taddr, ids_path,
                  str(max(n_files * 4, 300)), str(threads), cal_res)
        cal = _combine(load, cal_res)
        _require(cal["errors"] == 0, cal)
        capacity_qps = cal["qps"]
        rate_half = max(round(capacity_qps * half_factor, 1), 1.0)
        rate_over = max(round(capacity_qps * overload_factor, 1), 2.0)
        # The overload signals are calibrated off the daemon's own
        # saturated histograms (what its SLO evaluator reads).  Serving
        # 1 MB bodies off one reactor makes event-loop lag the true
        # saturation signal, so the loop-lag threshold (and the ladder's
        # loop-lag pressure knob) is a quarter of saturation: far above
        # the half-capacity lag, far below overload.  The per-op
        # download p99 stays sub-ms at every load (reads answer from
        # the page cache), so its threshold has a floor high enough
        # never to shed at half capacity.
        with StorageClient(st.ip, st.port, device=dev) as sc:
            hists = sc.stat()["histograms"]
        server_p99_us = hist_quantile(
            hists["op.download_file.latency_us"], 0.99) or 0.0
        sat_lag_p99_us = hist_quantile(
            hists["nio.loop_lag_us"], 0.99) or 0.0
        slo_threshold_ms = max(round(server_p99_us * 0.5 / 1000.0, 2), 5.0)
        loop_high_ms = max(int(sat_lag_p99_us * 0.25 / 1000.0), 10)
        base_over = open_loop(tmp, taddr, ids_path, rate_over,
                              overload_seconds, "overload")
        results["baseline"] = {"calibration": {
            "qps": capacity_qps, "lat_p50_us": cal["lat_p50_us"],
            "lat_p99_us": cal["lat_p99_us"],
            "server_download_p99_us": server_p99_us,
            "saturated_loop_lag_p99_us": sat_lag_p99_us},
            "overload": cell(base_over)}
    finally:
        cli.close()
        _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)

    # -- admission arm: the same offered rates, the ladder on -------------
    tmp = tempfile.mkdtemp(prefix="fdfs_cfg13_admission_")
    slo_path = os.path.join(tmp, "slo.conf")
    with open(slo_path, "w") as fh:
        fh.write(f"request_p99_ms_threshold = {slo_threshold_ms}\n")
        fh.write(f"loop_lag_p99_ms_threshold = {loop_high_ms}\n")
    tr, sts, cli = _cluster(
        tmp, dev, keys=base_keys
        + "\nadmission_control = 1"
        + "\nadmission_queue_depth_high = 8"
        + f"\nadmission_loop_lag_high_ms = {loop_high_ms}"
        + "\nadmission_retry_after_ms = 100"
        + f"\nslo_rules_file = {slo_path}")
    st = sts[0]
    taddr = f"127.0.0.1:{tr.port}"
    try:
        ids_path = preload(tmp, taddr, cli)
        adm_half = open_loop(tmp, taddr, ids_path, rate_half,
                             half_seconds, "half")
        gauges_half = admission_gauges(st)
        adm_over = open_loop(tmp, taddr, ids_path, rate_over,
                             overload_seconds, "overload")
        gauges_over = admission_gauges(st)
        results["admission"] = {"half": cell(adm_half),
                                "overload": cell(adm_over),
                                "gauges_after_half": gauges_half,
                                "gauges_after_overload": gauges_over}
    finally:
        cli.close()
        _stop(tr, sts)
        shutil.rmtree(tmp, ignore_errors=True)

    over = results["admission"]["overload"]
    base = results["baseline"]["overload"]
    bg = over["by_class"].get("background", {})
    nm = over["by_class"].get("normal", {})
    ia = over["by_class"].get("interactive", {})
    return emit(out_dir, 13, {
        "description": "SLO-driven admission control: the same "
                       "open-loop priority-mixed download load at "
                       "1.7x calibrated capacity against admission "
                       "off (p99 collapse) vs on (sheds background "
                       "first, interactive reads bounded), with a "
                       "zero-shed 50%-capacity arm and the ladder's "
                       "lifetime gauges",
        "nominal_bytes": NOMINAL[13],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "file_bytes": file_bytes,
        "threads": threads,
        "priority_mix": mix,
        "capacity_qps": capacity_qps,
        "slo_request_p99_threshold_ms": slo_threshold_ms,
        "slo_loop_lag_threshold_ms": loop_high_ms,
        "offered_rates_qps": {"half": rate_half, "overload": rate_over},
        "arms": results,
        "zero_sheds_at_half_capacity":
            results["admission"]["half"]["shed"] == 0
            and gauges_half.get("admission.shed_total", 0) == 0,
        "sheds_under_overload": over["shed"] > 0,
        "ladder_engaged":
            gauges_over.get("admission.tightens", 0) >= 1
            and gauges_over.get("admission.shed_total", 0) >= 1,
        "zero_non_shed_errors": all(
            c["non_shed_errors"] == 0
            for arm in results.values()
            for k, c in arm.items() if k in ("half", "overload")),
        "interactive_never_shed": ia.get("shed", 1) == 0,
        "shed_prefers_background":
            bg.get("shed", 0) * max(nm.get("ops", 1), 1)
            >= nm.get("shed", 0) * max(bg.get("ops", 1), 1),
        "goodput": {
            "capacity_qps": capacity_qps,
            "baseline_overload_qps": base["goodput_qps"],
            "admission_overload_qps": over["goodput_qps"],
        },
        "p99_collapse_ratio": round(
            base["lat_p99_us"]
            / max(ia.get("lat_p99_us", 1), 1), 2),
        "admitted_p99_bounded_vs_baseline":
            ia.get("lat_p99_us", 1 << 62) < base["lat_p99_us"],
    })


def config14(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """Heat-driven hot replication: the same two-tier read mix (one file
    takes 90% of the reads, ``--hot-keys 1:90``) against three groups of
    one storage each, the tracker's hot-map policy off and on.  Each arm
    uploads 8 KB flat files round-robin across the groups (small objects
    make the per-read RPCs, not bulk data, the dominant cost: every
    classic read is a tracker hop and a storage hop, all piling onto one
    tracker and one home group), warms the heat ledger with an
    ``fdfs_load --hot-keys`` leg through the tracker hop (its
    per-key-class summary is recorded), then, on the ON arm only, waits
    for the tracker to publish the promoted entry (which it does only
    after the fan-out byte-verified every extra copy), and last runs the
    measured legs: eight readers on the port's ``FdfsClient``, whose hot
    routing spreads the hot reads (the tracker's query_fetch never
    consults the hot map).  The readers write ``fdfs_load``-format
    record files tagged hot or cold, and ``fdfs_load combine`` prices
    both arms with the same percentile code.  Each arm measures twice: a
    closed-loop calibration leg (capacity), then an open-loop window at
    the same offered rate on both arms, 75% of the OFF arm's capacity,
    with latency from each op's scheduled start.  Per-group read shares
    come from the tracker's beat-stat ledger (``success_download``
    deltas across the window).  The artifact records that the ON arm
    published the promotion, the per-group read spread of each arm (the
    ON arm's within 10 points), the hot-key p99 of each, that routed
    reads flowed and that no read failed.  No kernel runs: the storages
    keep ``dedup_mode = none``.
    """
    dev = resolve_device(device)
    native = _native()
    storaged, trackerd, _ = native.native_binaries()
    load = native.load_binary()
    file_bytes = 8 << 10
    n_files = max(int(NOMINAL[14] * scale) // file_bytes, 12)
    hot_spec = "1:90"
    hot_frac = 0.90
    reader_threads = 8
    measure_seconds = 10.0
    calib_seconds = 4.0
    warm_ops = max(min(n_files * 20, 12000), 1200)
    warm_threads = 8
    group_names = ("group1", "group2", "group3")
    storage_conf = (HB
                    + "\nheat_top_k = 16"
                    + "\nwork_threads = 1")
    hot_conf = ("\nhot_promote_threshold = 3"
                "\nhot_demote_threshold = 1"
                "\nhot_max_extra_replicas = 2"
                "\nhot_map_capacity = 8")

    def group_reads(cli):
        """Per-group ``success_download`` totals from the tracker's
        beat-stat ledger; their deltas across the measured window are
        the spread."""
        out = {}
        for g in cli.cluster_stat().get("groups", []):
            out[g["name"]] = sum(int(s["stats"].get("success_download", 0))
                                 for s in g.get("storages", []))
        return out

    def all_active(cli):
        gr = cli.cluster_stat().get("groups", [])
        return (len(gr) == len(group_names)
                and all(g.get("active", 0) >= 1 for g in gr))

    def measured_window(taddr, ids, tmp, tag, seconds, rate_qps=None):
        """``reader_threads`` hot-routing clients drive the 1:90 mix for
        ``seconds``, each writing an ``fdfs_load``-format record file
        (with a trailing hot or cold tag) for ``fdfs_load combine``.

        ``rate_qps=None`` runs closed-loop, which measures capacity; its
        percentiles do not compare across arms (the faster arm completes
        more ops against the same CPUs and deepens its own tail).  With
        ``rate_qps`` the readers pace an open-loop schedule at that
        offered rate and latency counts from each op's scheduled start,
        so a reader that falls behind charges the backlog to the system
        and two arms at one rate compare percentile for percentile."""
        hot_fid, cold = ids[0], ids[1:]
        lines = [[] for _ in range(reader_threads)]
        # The default hot_map_ttl_s (5 s): the map is published and
        # stable when the window opens, and a short TTL would put inline
        # refresh RPCs inside the timed reads.
        clis = [FdfsClient([taddr], device=dev)
                for _ in range(reader_threads)]
        for c in clis:
            # Warm outside the clock: the first hot reads fetch the hot
            # map and rotate through every promoted copy, the first cold
            # reads open the pooled connections to the other groups.
            for fid in [hot_fid] * 3 + list(cold[:3]):
                c.download_to_buffer(fid)
        interval = (reader_threads / rate_qps) if rate_qps else 0.0
        start_mono = time.monotonic()
        start_wall = time.time()
        stop_at = start_mono + seconds

        def reader(w):
            rng = random.Random(0x40F0 + w)
            cli = clis[w]
            k = 0
            while True:
                sched = start_mono + k * interval
                k += 1
                if sched >= stop_at:
                    break
                now = time.monotonic()
                if interval and sched > now:
                    time.sleep(sched - now)
                elif not interval:
                    if now >= stop_at:
                        break
                    sched = now
                if rng.random() < hot_frac:
                    fid, tagk = hot_fid, "hot"
                else:
                    fid, tagk = cold[rng.randrange(len(cold))], "cold"
                try:
                    data = cli.download_to_buffer(fid)
                    status = 0 if len(data) == file_bytes else 22
                except Exception:  # noqa: BLE001 (priced as an error)
                    data, status = b"", 1
                lat = max(int((time.monotonic() - sched) * 1e6), 1)
                sched_us = int((start_wall + (sched - start_mono)) * 1e6)
                lines[w].append(f"{sched_us} {lat} {status} "
                                f"{len(data)} 0 {fid} {tagk}")

        workers = [threading.Thread(target=reader, args=(w,))
                   for w in range(reader_threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        paths = []
        for w in range(reader_threads):
            p = os.path.join(tmp, f"{tag}.reader{w}.result")
            with open(p, "w") as fh:
                fh.write("".join(ln + "\n" for ln in lines[w]))
            paths.append(p)
        routed = sum(c.stats()["hot_route_reads"] for c in clis)
        fallbacks = sum(c.stats()["hot_fallback_reads"] for c in clis)
        for c in clis:
            c.close()
        return _combine(load, *paths), routed, fallbacks

    def run_arm(promotion_on, offered_rate=None):
        tag = "on" if promotion_on else "off"
        tmp = tempfile.mkdtemp(prefix=f"fdfs_cfg14_{tag}_")
        tr = native.start_tracker(trackerd, os.path.join(tmp, "tr"),
                                  extra="slo_eval_interval_s = 1"
                                  + (hot_conf if promotion_on else ""))
        taddr = f"127.0.0.1:{tr.port}"
        storages = []
        cli = None
        try:
            for g in group_names:
                storages.append(native.start_storage(
                    storaged, os.path.join(tmp, g), group=g,
                    trackers=[taddr], extra=storage_conf))
            cli = FdfsClient([taddr], device=dev)
            _upload_retry(cli, b"warmup " * 64)
            _require(_wait_for(lambda: all_active(cli), timeout=60),
                     "storage groups never all joined")
            # Distinct payloads from fixed seeds (no cross-file dedup
            # collapsing the chunk store), placed round-robin across the
            # groups by the tracker (store_lookup 0).
            ids = [_upload_retry(cli,
                                 random.Random(0xC14 + i).randbytes(
                                     file_bytes))
                   for i in range(n_files)]
            ids_path = os.path.join(tmp, "corpus.ids")
            with open(ids_path, "w") as fh:
                fh.write("".join(fid + "\n" for fid in ids))
            hot_fid = ids[0]

            # Classic-path warm leg: fdfs_load --hot-keys drives the
            # two-tier mix through the tracker hop, feeding the heat
            # ledger; its summary prices the per-key-class split on the
            # classic path for this arm.
            warm_res = os.path.join(tmp, "warm.result")
            _run_load(load, "download", taddr, ids_path, str(warm_ops),
                      str(warm_threads), warm_res, "--hot-keys", hot_spec)
            warm = _combine(load, warm_res)
            _require(warm["errors"] == 0, warm)

            published_groups = []
            if promotion_on:
                deadline = time.time() + 120
                while time.time() < deadline and not published_groups:
                    m = cli.query_hot_map()
                    published_groups = next(
                        (list(e["groups"]) for e in m["entries"]
                         if e["key"] == hot_fid and e["groups"]), [])
                    if not published_groups:
                        # keep the EWMA warm while the fan-out verifies
                        cli.download_to_buffer(hot_fid)
                        time.sleep(0.2)
                _require(published_groups, "hot entry never published")

            # Closed-loop calibration leg: this arm's capacity with the
            # same readers.  The OFF arm's sets the offered rate of both
            # arms' open-loop windows (75% of it).
            calib, _, _ = measured_window(taddr, ids, tmp,
                                          tag + "_calib", calib_seconds)
            rate = offered_rate or max(int(calib["qps"] * 0.75), 100)

            time.sleep(2.5)  # let the last pre-window beats land
            before = group_reads(cli)
            agg, routed, fallbacks = measured_window(
                taddr, ids, tmp, tag, measure_seconds, rate)
            time.sleep(2.5)  # and the final post-window beats
            after = group_reads(cli)
            deltas = {g: after.get(g, 0) - before.get(g, 0) for g in after}
            total = max(sum(deltas.values()), 1)
            shares = {g: round(d / total, 4) for g, d in deltas.items()}
            spread_pp = round(
                (max(shares.values()) - min(shares.values())) * 100.0, 2)
            gauges = cli._with_tracker(lambda t: t.stat()).get("gauges", {})
            return {
                "closed_loop_capacity_qps": calib["qps"],
                "offered_rate_qps": rate,
                "classic_hot_keys_leg": {
                    "ops": warm["ops"], "qps": warm["qps"],
                    "errors": warm["errors"],
                    "by_key_class": warm.get("by_key_class", {})},
                "measured": {
                    "ops": agg["ops"], "qps": agg["qps"],
                    "errors": agg["errors"],
                    "lat_p50_us": agg["lat_p50_us"],
                    "lat_p99_us": agg["lat_p99_us"],
                    "by_key_class": agg.get("by_key_class", {})},
                "hot_route_reads": routed,
                "hot_fallback_reads": fallbacks,
                "published_extra_groups": published_groups,
                "group_read_deltas": deltas,
                "group_read_shares": shares,
                "group_spread_pp": spread_pp,
                "hot_gauges": {k: v for k, v in gauges.items()
                               if k.startswith("hot.")},
            }
        finally:
            if cli is not None:
                cli.close()
            _stop(tr, storages[::-1])
            shutil.rmtree(tmp, ignore_errors=True)

    os.makedirs(out_dir, exist_ok=True)
    off = run_arm(False)
    on = run_arm(True, offered_rate=off["offered_rate_qps"])
    on_hot = on["measured"]["by_key_class"].get("hot", {})
    off_hot = off["measured"]["by_key_class"].get("hot", {})
    return emit(out_dir, 14, {
        "description": "Heat-driven elastic replication: the same "
                       "1:90 hot/cold read mix against the hot-map "
                       "policy off vs on — post-promotion per-group "
                       "read spread within 10 pp where the off arm "
                       "piles onto the home group, hot-key p99 "
                       "flattened, routed reads flowing, zero errors "
                       "through the whole arc",
        "nominal_bytes": NOMINAL[14],
        "scaled_bytes": n_files * file_bytes,
        "card": card_line() if dev.type == "cuda" else None,
        "files": n_files,
        "file_bytes": file_bytes,
        "hot_keys_spec": hot_spec,
        "warm_ops": warm_ops,
        "reader_threads": reader_threads,
        "measure_seconds": measure_seconds,
        "offered_rate_qps": off["offered_rate_qps"],
        "off_capacity_qps": off["closed_loop_capacity_qps"],
        "on_capacity_qps": on["closed_loop_capacity_qps"],
        "open_loop_note":
            "each arm first runs a closed-loop calibration leg "
            "(closed_loop_capacity_qps); the latency window is then "
            "open-loop at the SAME offered rate on both arms (75% of "
            "the off arm's capacity) with latency measured from each "
            "op's scheduled start, because closed-loop percentiles "
            "self-penalize the faster arm: it completes more ops "
            "against the same CPUs and buys its throughput win with a "
            "deeper saturation tail",
        "host_cpus": os.cpu_count() or 1,
        "single_host_note":
            "all three storage groups, the tracker, the fdfs_load "
            "driver and the Python readers share this one host's CPUs, "
            "so the absolute qps columns are machine numbers, not "
            "cluster numbers; the transferable results are the "
            "per-group read-share spread and the ON-vs-OFF hot-key "
            "latency comparison, both measured identically on the two "
            "arms",
        "arms": {"off": off, "on": on},
        "hot_promotion_published": bool(on["published_extra_groups"]),
        "routed_reads_flowed": on["hot_route_reads"] > 0,
        "off_group_spread_pp": off["group_spread_pp"],
        "on_group_spread_pp": on["group_spread_pp"],
        "post_promotion_spread_within_10pp":
            on["group_spread_pp"] <= 10.0,
        "hot_p99_off_us": off_hot.get("lat_p99_us", 0),
        "hot_p99_on_us": on_hot.get("lat_p99_us", 0),
        "hot_p99_flatter_with_promotion":
            0 < on_hot.get("lat_p99_us", 0)
            < off_hot.get("lat_p99_us", 1),
        "zero_read_errors":
            off["measured"]["errors"] == 0
            and on["measured"]["errors"] == 0,
    })


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6, 7: config7, 8: config8, 9: config9, 10: config10,
           11: config11, 12: config12, 13: config13, 14: config14}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="configs 1-14 of bench_configs.py on the port")
    ap.add_argument("--config", type=int, default=0,
                    choices=[0, *sorted(CONFIGS)],
                    help="which config (1-14); 0 = all, in order")
    ap.add_argument("--scale", type=float, default=None,
                    help="fraction of the nominal corpus size")
    ap.add_argument("--full", action="store_true",
                    help="run the nominal (BASELINE.json) sizes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    for c in [args.config] if args.config else sorted(CONFIGS):
        scale = 1.0 if args.full else (
            args.scale if args.scale is not None else DEFAULT_SCALE[c])
        CONFIGS[c](args.out, scale, args.device)


if __name__ == "__main__":
    main()
