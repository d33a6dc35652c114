"""Dedup sidecar on a CUDA card: the port of ``fastdfs_tpu/sidecar.py``.

The server half of the storage daemon's ``dedup_mode = sidecar`` plugin
(C++ client: ``native/storage/dedup.cc:SidecarDedup``): a unix-socket
service speaking the standard 10-byte framing with the DEDUP_* opcodes,
byte-for-byte as the reference does, so a live daemon runs on it with no
change to ``native/``.  Fingerprints come from the port's
:class:`DedupEngine`, whose SHA-1 and survivor-sketch kernels are
hand-written CUDA.

Opcodes
-------
* ``DEDUP_FINGERPRINT`` (120): body = 8B BE session id + 8B BE
  base_offset + raw segment bytes; the engine chunks the segment on the
  device.  Response: 8B BE chunk count, then per chunk 8B BE offset + 8B
  BE length + 20B raw SHA1.  The session id scopes all pending state (the
  accumulated file signature and per-chunk digest attributions) until
  commit/abort, so nothing provisional reaches the indexes.
* ``DEDUP_FINGERPRINT_CUTS`` (125): DEDUP_FINGERPRINT with the cut
  offsets from the daemon's own chunker (8B session + 8B base_offset +
  8B n_cuts + n_cuts x 8B ends + bytes) — the production path.
* ``DEDUP_QUERY`` (121): body = 40-hex whole-file SHA1.  Response: the
  canonical file id if known.
* ``DEDUP_COMMIT`` (122): text body, one of
  ``commitfile <sha1hex> <file_id>`` | ``commitchunks <session> <file_id>``
  | ``abort <session>`` | ``forget <file_id>`` | ``stats`` | ``trace``
  (the newest ``TRACE_SPANS`` spans of the process's span ring, where
  the engine writes the stages of every fingerprint call, as a
  ``TRACE_DUMP`` object with role ``sidecar`` and the ring's
  ``recorded`` and ``dropped``).
* ``DEDUP_NEARDUPS`` (123): body = file id text.  Response: ranked text
  lines ``<file_id> <score>``; status 61 when the file carries no
  signature.
* ``DEDUP_VERIFY`` (136): batched chunk-integrity verify for the storage
  scrubber.  Body = 8B count + per chunk (8B length + 20B expected raw
  SHA1) + payloads; response = count bytes (0 = match, 1 = mismatch).
  Hashing runs through the SHA-1 kernel.  A failed kernel answers a
  non-zero status (the daemon then uses its own host SHA1); it never
  falls back silently.

State: whole-file digest map + the engine's exact/LSH indexes, in the
same snapshot files and formats as the reference
(``<state_dir>/sidecar_files.json``, ``sidecar_exact.npz``,
``sidecar_near.npz``), so either sidecar resumes the other's state.

``DedupSidecar.handle(cmd, body)`` answers one request as the socket
loop does, and ``commit_chunks`` indexes one stored file as
``commitchunks`` does.  Every fingerprint, ``commitchunks``, near-dup and
``forget`` request writes its stages into the process's span ring
(``sidecar.*`` roots, the index's ``index.*`` stages beneath them); the
``stats`` answer adds the indexes' counts.

Run: ``python -m fastdfs_tpu_torch.sidecar --socket /path/dedup.sock``
(``--platform cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import struct
import sys
import threading
import time

import numpy as np
import torch

from fastdfs_tpu_torch.common.protocol import (HEADER_SIZE, StorageCmd,
                                               pack_header, unpack_header)
from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine
from fastdfs_tpu_torch.dedup import index as idx
from fastdfs_tpu_torch.dedup.index import ExactDigestIndex
from fastdfs_tpu_torch.ops import SEGMENT_SLACK
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_ragged_cuda
from fastdfs_tpu_torch.ops.gear_cdc import CDC_SPEC_VERSION
from fastdfs_tpu_torch.ops.sha1 import digest_bytes
from fastdfs_tpu_torch.trace import SPAN_RING, CallSpans

_I64 = struct.Struct(">q")
# DEDUP_VERIFY's per-chunk header: 8B BE length + 20B expected raw SHA1.
_VERIFY_ENTRY = np.dtype([("length", ">i8"), ("digest", "S20")])

_SESSION_TTL = 600.0  # seconds before an uncommitted session is reaped
# How many of the newest spans the ``trace`` commit subcommand returns.
TRACE_SPANS = 4096

# The request handlers' spans in the process's span ring: one root a
# request, its children one after another from its start to its end (the
# index's stages are named in ``dedup.index``).  A fingerprint request's
# ``sidecar.engine`` holds the engine's own call, a root of its own.
_FINGERPRINT_ROOT = "sidecar.fingerprint"
_COMMIT_ROOT = "sidecar.commit"
_NEARDUPS_ROOT = "sidecar.neardups"
_FORGET_ROOT = "sidecar.forget"
_PARSE = SPAN_RING.code("sidecar.parse")
_ENGINE = SPAN_RING.code("sidecar.engine")
_LOCK_WAIT = SPAN_RING.code("sidecar.lock_wait")
_RESPOND = SPAN_RING.code("sidecar.respond")


class _Session:
    """Pending per-upload state: accumulated file signature + the digest
    attributions to insert (with the real file id) at commit time."""

    __slots__ = ("sig", "digests", "touched")

    def __init__(self) -> None:
        self.sig: np.ndarray | None = None
        self.digests: list[tuple[bytes, int]] = []  # (raw digest, offset)
        self.touched = time.monotonic()


def _parse_session(token: str) -> int:
    try:
        return int(token)
    except ValueError:
        return -1


class DedupSidecar:
    """Unix-socket dedup service around a :class:`DedupEngine`.

    One engine (on one device) serves every daemon connection; session,
    stats and index mutation are serialized under a lock — batching
    happens inside the engine (one launch of each kernel per segment),
    not across requests.
    """

    def __init__(self, socket_path: str, state_dir: str | None = None,
                 config: DedupConfig | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.socket_path = socket_path
        self.state_dir = state_dir
        self.engine = DedupEngine(config, device=device)
        self.device = self.engine.device
        self.files: dict[str, str] = {}       # whole-file sha1 -> file id
        self.by_file: dict[str, str] = {}     # file id -> sha1
        self._sessions: dict[int, _Session] = {}  # session id -> pending
        self._lock = threading.Lock()
        self._recorders = threading.local()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        # RSS watchdog (see _housekeeping_loop): 0 disables; restart_argv
        # is the CLI argv to re-exec with.
        self.max_rss_mb: int = 0
        self.restart_argv: list[str] = []
        self._started = time.monotonic()
        # lock_wait_us / engine_us price the one-engine-serialization
        # design: lock_wait is time requests spent queued on _lock,
        # engine is time actually inside engine.fingerprint.  Read via
        # the `stats` commit subcommand (bench stage attribution);
        # the answer adds the engine's staging-copy counters
        # (DedupEngine.stage_counts) and the indexes' counts().
        self.stats = {"fingerprint_bytes": 0, "chunks": 0, "requests": 0,
                      "lock_wait_us": 0, "engine_us": 0}
        if state_dir:
            self._load_state()

    # -- state -------------------------------------------------------------

    def _state_paths(self) -> tuple[str, str, str]:
        d = self.state_dir or "."
        return (os.path.join(d, "sidecar_files.json"),
                os.path.join(d, "sidecar_exact.npz"),
                os.path.join(d, "sidecar_near.npz"))

    def _load_state(self) -> None:
        files_p, exact_p, near_p = self._state_paths()
        if os.path.exists(files_p):
            with open(files_p) as fh:
                blob = json.load(fh)
            # Current format: {"cdc_spec": N, "cdc_policy": P,
            # "files": {...}}; round-4 snapshots were the flat files dict
            # (spec 1 implicitly); pre-round-13 ones carry no policy
            # field (policy 1 implicitly).
            if isinstance(blob, dict) and "files" in blob:
                spec = int(blob.get("cdc_spec", 1))
                policy = int(blob.get("cdc_policy", 1))
                files = blob["files"]
            else:
                spec, policy, files = 1, 1, blob
            if spec != CDC_SPEC_VERSION:
                # Stale chunker spec: the same bytes now chunk at
                # different offsets, so every stored chunk digest would
                # miss — discard ALL dedup state (cold restart; recipes
                # and reads are unaffected) instead of silently serving
                # a dead index.
                print(f"dedup sidecar: discarding snapshot built with "
                      f"chunker spec v{spec} (current v{CDC_SPEC_VERSION})",
                      flush=True)
                return
            if policy != self.engine.config.cdc_policy:
                # Same rule for the cut-selection policy: default and
                # skip-min cuts are different content-address namespaces,
                # so an index built under one is dead weight (and silent
                # ~0% dedup) under the other.
                print(f"dedup sidecar: discarding snapshot built with "
                      f"cdc_policy {policy} (engine runs policy "
                      f"{self.engine.config.cdc_policy})", flush=True)
                return
            self.files = files
            self.by_file = {v: k for k, v in self.files.items()}
        elif os.path.exists(exact_p) or os.path.exists(near_p):
            # Index snapshots without the files/spec record: unknown
            # chunker spec — same discard rule.
            print("dedup sidecar: discarding index snapshots with no "
                  "chunker-spec record", flush=True)
            return
        if os.path.exists(exact_p) and os.path.exists(near_p):
            try:
                self.engine = DedupEngine.load(exact_p, near_p,
                                               self.engine.config,
                                               device=self.device)
            except Exception as e:
                # A stale-spec, truncated, or otherwise unreadable
                # snapshot must not brick the sidecar (which would
                # fail-open EVERY upload to flat storage): keep whatever
                # exact state loads, restart the near index.
                print(f"dedup sidecar: dropping near-dup snapshot ({e}); "
                      "exact dedup state retained", flush=True)
                fresh = DedupEngine(self.engine.config, device=self.device)
                try:
                    fresh.exact = ExactDigestIndex.load(exact_p)
                except Exception:
                    pass
                self.engine = fresh

    def save_state(self) -> None:
        if not self.state_dir:
            return
        files_p, exact_p, near_p = self._state_paths()
        with self._lock:
            tmp = files_p + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"cdc_spec": CDC_SPEC_VERSION,
                           "cdc_policy": self.engine.config.cdc_policy,
                           "files": self.files}, fh)
            os.replace(tmp, files_p)
            self.engine.save(exact_p, near_p)

    # -- request handlers --------------------------------------------------

    def handle(self, cmd: int, body: bytes) -> tuple[int, bytes]:
        """One request's status and response body, as the socket loop
        sends them back; counts ``requests``."""
        self.stats["requests"] += 1
        if cmd == StorageCmd.DEDUP_FINGERPRINT:
            return self._fingerprint(body)
        if cmd == StorageCmd.DEDUP_FINGERPRINT_CUTS:
            return self._fingerprint(body, with_cuts=True)
        if cmd == StorageCmd.DEDUP_QUERY:
            return self._query(body)
        if cmd == StorageCmd.DEDUP_COMMIT:
            return self._commit(body)
        if cmd == StorageCmd.DEDUP_NEARDUPS:
            return self._neardups(body)
        if cmd == StorageCmd.DEDUP_VERIFY:
            return self._verify(body)
        if cmd == StorageCmd.ACTIVE_TEST:
            return 0, b""
        return 22, b""

    def _spans(self, root: str) -> CallSpans:
        """This thread's recorder of ``root`` calls."""
        recs = getattr(self._recorders, "by_root", None)
        if recs is None:
            recs = self._recorders.by_root = {}
        rec = recs.get(root)
        if rec is None:
            rec = recs[root] = CallSpans(SPAN_RING, root)
        return rec

    def commit_chunks(self, file_id: str, digests, sig) -> None:
        """Index one stored file: each ``(raw digest, offset)`` chunk
        attributed to ``file_id`` (a digest already indexed keeps its
        first carrier) and the file's signature (None: no chunks).  A
        bulk load calls it with a stored file's chunks; ``commitchunks``
        makes the same updates (``_index``) with a session's, under the
        hold of the lock that takes the session, so both build the same
        state."""
        rec = self._spans(_COMMIT_ROOT)
        rec.open()
        with self._lock:
            rec.end(_LOCK_WAIT)
            self._index(rec, file_id, digests, sig)

    def _index(self, rec: CallSpans, file_id: str, digests, sig) -> None:
        """``commit_chunks``' updates; the caller holds the lock."""
        for dig, off in digests:
            self.engine.exact.insert(dig, [file_id, off])
        rec.end(idx.EXACT_INSERT)
        if sig is not None:
            self.engine.near.add(sig, file_id)
        rec.close(idx.NEAR_ADD)

    def _fingerprint(self, body: bytes, with_cuts: bool = False
                     ) -> tuple[int, bytes]:
        rec = self._spans(_FINGERPRINT_ROOT)
        rec.open()
        if len(body) < 16:
            return 22, b""
        session_id = _I64.unpack_from(body)[0]
        base_offset = _I64.unpack_from(body, 8)[0]
        cuts = None
        if with_cuts:
            # DEDUP_FINGERPRINT_CUTS: the daemon already ran the
            # (identical) native CDC; body carries the cut offsets.
            if len(body) < 24:
                return 22, b""
            n_cuts = _I64.unpack_from(body, 16)[0]
            if n_cuts < 0 or 24 + 8 * n_cuts > len(body):
                return 22, b""
            cuts = [_I64.unpack_from(body, 24 + 8 * i)[0]
                    for i in range(n_cuts)]
            data = body[24 + 8 * n_cuts:]
            # Cuts must exactly cover the payload: an empty cut list
            # with data would "succeed" with zero chunks and a recipe
            # covering none of the bytes.
            if data:
                if (not cuts or cuts[-1] != len(data)
                        or any(c <= p for p, c in zip([0] + cuts, cuts))):
                    return 22, b""
            elif cuts:
                return 22, b""
        else:
            data = body[16:]
        rec.end(_PARSE)
        # Pure compute OUTSIDE the lock: engine.fingerprint touches no
        # index state (its docstring is the contract) and its staging is
        # per thread — so concurrent daemon uploads overlap their device
        # round-trips instead of queueing behind one global lock.
        # Only session/stats/index mutation is serialized.
        t_start = time.monotonic()
        spans, digests, sigs = self.engine.fingerprint(data, cuts=cuts)
        t_wait = time.monotonic()
        rec.end(_ENGINE)
        with self._lock:
            t_held = time.monotonic()
            rec.end(_LOCK_WAIT)
            self.stats["lock_wait_us"] += int((t_held - t_wait) * 1e6)
            self.stats["engine_us"] += int((t_wait - t_start) * 1e6)
            sess = self._sessions.setdefault(session_id, _Session())
            sess.touched = time.monotonic()
            raw = np.asarray(digests, dtype=">u4").tobytes()
            out = [_I64.pack(len(spans))]
            for i, (off, ln) in enumerate(spans):
                out.append(_I64.pack(base_offset + off))
                out.append(_I64.pack(ln))
                # Digest attribution (which file first carried a chunk,
                # for near-dup reporting) stays buffered in the session
                # until commit binds the real file id — the index never
                # sees provisional entries.
                dig = raw[i * 20:(i + 1) * 20]
                out.append(dig)
                sess.digests.append((dig, base_offset + off))
            if len(spans):
                sig = np.asarray(sigs).min(axis=0)
                sess.sig = sig if sess.sig is None else np.minimum(sess.sig, sig)
            self.stats["fingerprint_bytes"] += len(data)
            self.stats["chunks"] += len(spans)
        resp = b"".join(out)
        rec.close(_RESPOND)
        return 0, resp

    def _query(self, body: bytes) -> tuple[int, bytes]:
        sha1_hex = body.decode("ascii", "replace").strip()
        with self._lock:
            fid = self.files.get(sha1_hex)
        return 0, fid.encode() if fid else b""

    def _commit(self, body: bytes) -> tuple[int, bytes]:
        parts = body.decode("utf-8", "replace").split()
        if not parts:
            return 22, b""
        if parts == ["trace"]:
            return 0, json.dumps(SPAN_RING.dump("sidecar",
                                                newest=TRACE_SPANS)).encode()
        if parts[0] == "commitchunks" and len(parts) == 3:
            rec = self._spans(_COMMIT_ROOT)
            rec.open()
            with self._lock:
                rec.end(_LOCK_WAIT)
                sess = self._sessions.pop(_parse_session(parts[1]), None)
                if sess is not None:
                    self._index(rec, parts[2], sess.digests, sess.sig)
            return 0, b""
        if parts[0] == "forget" and len(parts) == 2:
            self._forget(parts[1])
            return 0, b""
        with self._lock:
            if parts[0] == "commitfile" and len(parts) == 3:
                self.files.setdefault(parts[1], parts[2])
                self.by_file[parts[2]] = parts[1]
                return 0, b""
            if parts[0] == "stats" and len(parts) == 1:
                return 0, json.dumps({**self.stats,
                                      **self.engine.stage_counts,
                                      **self.engine.exact.counts(),
                                      **self.engine.near.counts()}).encode()
            if parts[0] == "abort" and len(parts) == 2:
                self._sessions.pop(_parse_session(parts[1]), None)
                return 0, b""
        return 22, b""

    def _forget(self, file_id: str) -> None:
        rec = self._spans(_FORGET_ROOT)
        rec.open()
        with self._lock:
            rec.end(_LOCK_WAIT)
            sha1 = self.by_file.pop(file_id, None)
            if sha1 is not None and self.files.get(sha1) == file_id:
                del self.files[sha1]
            self.engine.near.remove(file_id)
            rec.end(idx.NEAR_REMOVE)
            # Exact attributions for the deleted file leave the index
            # too (they would otherwise accumulate in RAM + snapshots
            # forever).  The daemon's ChunkStore owns true chunk
            # refcounts; this index only answers "who first carried
            # it", so dropping the tombstoned carrier is safe — a
            # later upload of the same chunk re-attributes it.  One
            # vectorized pass over the index's carrier column — no
            # per-file digest-list side table in RAM.
            self.engine.exact.remove_by_carrier(file_id)
            rec.close(idx.EXACT_REMOVE)

    def _verify(self, body: bytes) -> tuple[int, bytes]:
        """DEDUP_VERIFY (136): batched chunk-integrity check for the
        storage scrubber.  Body = 8B count + count x (8B length + 20B
        expected raw SHA1) + payloads concatenated; response = count
        bytes (0 = match, 1 = mismatch).

        Pure compute — no index or session state — so it runs entirely
        outside the engine lock, through the SHA-1 kernel (one ragged
        launch over the payloads as they arrived).  A failed kernel answers status 5
        (EIO): the daemon then verifies with its own host SHA1, so a
        verify answer is never wrong and a broken kernel is never hidden.
        """
        if len(body) < 8:
            return 22, b""
        count = _I64.unpack_from(body)[0]
        if count < 0 or 8 + count * 28 > len(body):
            return 22, b""
        head = np.frombuffer(body, dtype=_VERIFY_ENTRY, count=count, offset=8)
        lengths = head["length"].astype(np.int64)
        start = 8 + count * 28
        rest = len(body) - start
        if ((count and (lengths.min() < 0 or lengths.max() > rest))
                or int(lengths.sum()) != rest):
            return 22, b""
        try:
            got = self._batch_sha1(body, start, lengths)
        except Exception as e:  # noqa: BLE001 — report, never fall back
            print(f"dedup sidecar: batched verify failed "
                  f"({type(e).__name__}: {e})", flush=True)
            return 5, b""
        want = np.frombuffer(head["digest"].tobytes(), dtype=np.uint8)
        return 0, (got != want.reshape(count, 20)).any(axis=1).astype(
            np.uint8).tobytes()

    def _batch_sha1(self, body: bytes, start: int,
                    lengths: np.ndarray) -> np.ndarray:
        """One ragged SHA-1 launch over the payloads as they arrived
        (``body[start:]``, chunk i at the running sum of the lengths before
        it) -> uint8 (N, 20) raw digests."""
        n = len(lengths)
        if not n:
            return np.zeros((0, 20), dtype=np.uint8)
        if lengths.max() >= 1 << 31:
            raise ValueError("a verify chunk of 2 GiB or more")
        size = len(body) - start
        seg = torch.zeros(size + SEGMENT_SLACK, dtype=torch.uint8)
        seg.numpy()[:size] = np.frombuffer(body, dtype=np.uint8, offset=start)
        offsets = np.cumsum(lengths) - lengths
        order = np.argsort(-lengths, kind="stable").astype(np.int32)
        dev = self.device
        digests = sha1_ragged_cuda(
            seg.to(dev), torch.from_numpy(offsets).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev),
            torch.from_numpy(order).to(dev))
        return np.frombuffer(digest_bytes(digests),
                             dtype=np.uint8).reshape(n, 20)

    def _neardups(self, body: bytes) -> tuple[int, bytes]:
        """Ranked near-dup report for a stored file id (the production
        query surface for the LSH index; without it the index is
        write-only).  Status 61 (ENODATA) when the file is unknown to the
        near index — flat, whole-file-deduped, or never committed."""
        file_id = body.decode("utf-8", "replace").strip()
        if not file_id:
            return 22, b""
        rec = self._spans(_NEARDUPS_ROOT)
        rec.open()
        with self._lock:
            rec.end(_LOCK_WAIT)
            sig = self.engine.near.signature_of(file_id)
            if sig is None:
                return 61, b""
            cfg = self.engine.config
            pairs = self.engine.near.query(
                sig, top_k=cfg.near_dup_top_k * 2 + 1,
                min_similarity=cfg.near_dup_threshold, spans=rec)
        lines = [f"{ref} {score:.4f}" for ref, score in pairs
                 if ref != file_id][:self.engine.config.near_dup_top_k * 2]
        resp = "\n".join(lines).encode()
        rec.close(_RESPOND)
        return 0, resp

    def _reap_stale_sessions(self) -> None:
        cutoff = time.monotonic() - _SESSION_TTL
        with self._lock:
            stale = [s for s, sess in self._sessions.items()
                     if sess.touched < cutoff]
            for s in stale:
                del self._sessions[s]
        if stale:
            print(f"dedup sidecar: reaped {len(stale)} stale sessions",
                  flush=True)

    # -- server loop -------------------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, HEADER_SIZE)
                if hdr is None:
                    return
                h = unpack_header(hdr)
                if h.pkg_len < 0 or h.pkg_len > (1 << 31):
                    return
                body = self._recv_exact(conn, h.pkg_len) if h.pkg_len else b""
                if body is None:
                    return
                status, resp = self.handle(h.cmd, body)
                conn.sendall(pack_header(len(resp),
                                          StorageCmd.RESP, status) + resp)
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
        # Into one preallocated buffer: recv(n - len(buf)) would allocate
        # a fresh body-sized buffer for every socket read, which cost
        # over a second per 64 MB segment on an H100 host (PERF.md).
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = conn.recv_into(view[got:])
            if not k:
                return None
            got += k
        return bytes(buf)

    @staticmethod
    def _rss_mb() -> float:
        try:
            with open("/proc/self/status") as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            pass
        return 0.0

    def _housekeeping_loop(self, snapshot_interval: float) -> None:
        """Snapshot + stale-session reaping on a dedicated timer thread:
        a steadily-busy listener must not defer them (the accept-timeout
        scheduling they used to ride starves under sustained traffic,
        making crash loss unbounded instead of one snapshot interval).

        Also the RSS watchdog, kept from the reference: over the limit,
        the loop snapshots state and re-execs the process in place — the
        daemon side fails open and retries on fresh connections, so
        service degrades to flat storage for the ~warmup window instead
        of growing without bound."""
        while not self._stop.wait(snapshot_interval):
            # Catch EVERYTHING: one bad snapshot attempt (OSError, but
            # also numpy/json errors from racing state) must not kill the
            # thread and silently disable snapshots + session reaping.
            snap_ok = True
            try:
                self.save_state()
            except Exception as e:
                snap_ok = False
                print(f"dedup sidecar: snapshot failed: {e}", flush=True)
            try:
                self._reap_stale_sessions()
            except Exception as e:
                print(f"dedup sidecar: session reap failed: {e}", flush=True)
            # Re-exec ONLY on the back of a successful snapshot — losing
            # everything since the last good one would make crash loss
            # unbounded, the exact failure bound this loop guarantees.
            if snap_ok and self.max_rss_mb > 0 and self.restart_argv:
                rss = self._rss_mb()
                if rss > self.max_rss_mb:
                    # A trip EARLY in the process's life means the limit
                    # sits below the natural baseline (misconfiguration:
                    # restarting cannot help — that's what the consecutive
                    # counter and its disable guard catch).  A trip after
                    # a long healthy run is the leak doing what leaks do;
                    # resetting the counter keeps the watchdog alive for
                    # the service's whole lifetime.
                    uptime = time.monotonic() - self._started
                    if uptime < 600.0:
                        os.environ["FDFS_SIDECAR_RESTARTS"] = str(
                            int(os.environ.get("FDFS_SIDECAR_RESTARTS",
                                               "0")) + 1)
                    else:
                        os.environ["FDFS_SIDECAR_RESTARTS"] = "0"
                    print(f"dedup sidecar: rss {rss:.0f} MB > limit "
                          f"{self.max_rss_mb} MB after {uptime:.0f}s — "
                          "re-exec (state saved)", flush=True)
                    os.execv(sys.executable,
                             [sys.executable, "-m", "fastdfs_tpu_torch.sidecar",
                              *self.restart_argv])

    def serve_forever(self, ready_event: threading.Event | None = None,
                      snapshot_interval: float = 60.0) -> None:
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(16)
        self._listener.settimeout(0.5)
        if ready_event is not None:
            ready_event.set()
        housekeeper = threading.Thread(
            target=self._housekeeping_loop, args=(snapshot_interval,),
            daemon=True)
        housekeeper.start()
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn,
                             args=(conn,), daemon=True).start()
        self._stop.set()
        housekeeper.join(timeout=5.0)
        self.save_state()
        self._listener.close()
        try:
            os.unlink(self.socket_path)
        except FileNotFoundError:
            pass

    def stop(self) -> None:
        self._stop.set()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="fastdfs_tpu_torch dedup sidecar (CUDA)")
    ap.add_argument("--socket", required=True, help="unix socket path")
    ap.add_argument("--state-dir", default=None,
                    help="snapshot dir (checkpoint/resume)")
    ap.add_argument("--snapshot-interval", type=float, default=60.0)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device the engine runs on (default cuda; cpu runs "
                         "the plain PyTorch path).  cuda without a visible "
                         "card is an error, never a fallback.")
    ap.add_argument("--max-rss-mb", type=int, default=24576,
                    help="RSS watchdog: snapshot state and re-exec the "
                         "process above this resident size (0 disables); "
                         "the daemon fails open during the restart window.")
    ap.add_argument("--cdc-policy", type=int, default=1, choices=(1, 2),
                    help="cut-selection policy: 1 = default (frozen, "
                         "ref-identical cuts), 2 = skip-min "
                         "(arXiv:2508.05797; different boundaries — new "
                         "groups only, see OPERATIONS.md).  Snapshots "
                         "built under another policy are discarded at "
                         "load.")
    ap.add_argument("--fan-out", type=int, default=None,
                    help="split each segment's chunks over this many "
                         "devices, one launch of each kernel per device "
                         "(default: every visible card on cuda, 1 on cpu; "
                         "more cards than are visible is an error)")
    args = ap.parse_args(argv)

    config = DedupConfig(cdc_policy=args.cdc_policy, fan_out=args.fan_out)
    sidecar = DedupSidecar(args.socket, state_dir=args.state_dir,
                           config=config, device=args.platform)
    # Restart-loop guard: a limit below the process's natural baseline
    # (misconfiguration) would otherwise re-exec every tick forever,
    # each cycle costing a warmup of degraded-to-flat service.  After
    # two watchdog restarts the guard disables itself and stays up.
    restarts = int(os.environ.get("FDFS_SIDECAR_RESTARTS", "0"))
    if restarts >= 2 and args.max_rss_mb > 0:
        print(f"dedup sidecar: {restarts} watchdog restarts — limit "
              f"{args.max_rss_mb} MB looks below baseline; watchdog "
              "DISABLED for this process", flush=True)
        sidecar.max_rss_mb = 0
    else:
        sidecar.max_rss_mb = args.max_rss_mb
    sidecar.restart_argv = list(argv) if argv is not None else sys.argv[1:]
    signal.signal(signal.SIGTERM, lambda *_: sidecar.stop())
    signal.signal(signal.SIGINT, lambda *_: sidecar.stop())
    t0 = time.monotonic()
    sidecar.engine.warmup()  # build + run every shape BEFORE accepting traffic
    print(f"dedup sidecar warmed in {time.monotonic() - t0:.1f}s, "
          f"listening on {args.socket}", flush=True)
    sidecar.serve_forever(snapshot_interval=args.snapshot_interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
