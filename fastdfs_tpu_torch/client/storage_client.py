"""Storage-daemon client: the data-path API.

The port's copy of ``fastdfs_tpu/client/storage_client.py``: the same
requests, byte for byte, against the C++ daemon in
``native/storage/server.cc``.  One argument is new: ``device``, where
``upload_buffer_dedup`` fingerprints the payload (``cuda`` unless the
caller passes ``cpu``; ``client.fingerprint.fingerprint_buffer``).  It is
resolved once in the constructor, so asking for CUDA on a host without a
card raises before any socket opens.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass

import torch

from fastdfs_tpu_torch.client.conn import (Connection, ProtocolError,
                                          StatusError)
from fastdfs_tpu_torch.client.fingerprint import fingerprint_buffer
from fastdfs_tpu_torch.common.protocol import (
    GROUP_NAME_MAX_LEN,
    MAX_INLINE_BODY,
    StorageCmd,
    long2buff,
    buff2long,
    pack_ext_name,
    pack_group_name,
    pack_metadata,
    pack_prefix_name,
    pack_profile_ctl,
    unpack_group_name,
    unpack_metadata,
    unpack_ec_stats,
    unpack_scrub_stats,
)
from fastdfs_tpu_torch.ops import resolve_device

AUTO_STORE_PATH = 0xFF


def _parse_upload_response(body: bytes) -> str:
    """Decode the shared upload response shape (16B group + remote name)
    into a file ID — one definition for every upload variant."""
    if len(body) <= GROUP_NAME_MAX_LEN:
        raise ProtocolError(f"short upload response: {len(body)}")
    group = unpack_group_name(body[:GROUP_NAME_MAX_LEN])
    return f"{group}/{body[GROUP_NAME_MAX_LEN:].decode()}"

# Segment size for streamed request bodies (uploads read the source in
# pieces this big, so a multi-GB file holds O(segment) client memory).
UPLOAD_SEGMENT_BYTES = 1 << 20

# Statuses that mean "this daemon cannot serve a negotiated upload" (95 =
# ENOTSUP: no chunk store; 22 = EINVAL: an OLDER daemon rejecting the
# unknown opcode) — the client falls back to a plain UPLOAD_FILE.
_DEDUP_FALLBACK_STATUSES = (22, 95)


def pack_upload_recipe(store_path_index: int, ext: str, crc32: int,
                       logical_size: int,
                       chunks: list[tuple[int, bytes]]) -> bytes:
    """UPLOAD_RECIPE request body (phase 1 of the negotiated upload).

    ``chunks`` is [(length, 20B raw sha1)] in stream order.  Wire: 1B
    store-path index + 6B ext + 8B crc32 + 8B logical_size + 8B count +
    per chunk (20B digest + 8B length) — the recipe entry encoding every
    chunk-aware opcode shares.  Covered by the ``fdfs_codec ingest-wire``
    cross-language golden.
    """
    parts = [bytes([store_path_index]), pack_ext_name(ext),
             long2buff(crc32 & 0xFFFFFFFF), long2buff(logical_size),
             long2buff(len(chunks))]
    for length, digest in chunks:
        if len(digest) != 20:
            raise ValueError(f"digest must be 20 raw bytes, got {len(digest)}")
        parts.append(digest)
        parts.append(long2buff(length))
    return b"".join(parts)


def unpack_upload_recipe_resp(body: bytes, n_chunks: int) -> tuple[int, bytes]:
    """(session_id, needed-bitmap) from an UPLOAD_RECIPE response; byte i
    of the bitmap is 1 when chunk i must be shipped in phase 2."""
    if len(body) != 8 + n_chunks:
        raise ProtocolError(
            f"bad UPLOAD_RECIPE response: {len(body)} != {8 + n_chunks}")
    return buff2long(body), body[8:]


def pack_upload_chunks_prefix(session_id: int, payload_len: int) -> bytes:
    """UPLOAD_CHUNKS fixed prefix (phase 2): 8B session + 8B payload_len;
    the needed chunks' payloads follow in recipe order."""
    return long2buff(session_id) + long2buff(payload_len)


@dataclass(frozen=True)
class RemoteFileInfo:
    file_size: int
    create_timestamp: int
    crc32: int
    source_ip: str


class StorageClient:
    """One storage server connection (context manager)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 conn: Connection | None = None, release=None,
                 device: str | torch.device = "cuda"):
        # Where upload_buffer_dedup fingerprints; resolved before the
        # connect, so a missing card raises with no socket to leak.
        self.device = resolve_device(device)
        # `conn`/`release` inject a pooled connection (ConnectionPool):
        # close() then parks it instead of closing the socket.
        self.conn = conn if conn is not None else Connection(host, port, timeout)
        self._release = release

    def close(self) -> None:
        conn, self.conn = self.conn, None
        if conn is None:
            return  # idempotent: the pool may already own the socket
        if self._release is not None:
            release, self._release = self._release, None
            release(conn)
        else:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- uploads -----------------------------------------------------------

    def upload_buffer(self, data: bytes, ext: str = "",
                      store_path_index: int = AUTO_STORE_PATH,
                      appender: bool = False) -> str:
        """Upload bytes; returns the file ID (``group/Mxx/aa/bb/name.ext``).

        Wire (reference storage_do_upload_file): 1B store-path index
        (0xFF = server picks), 8B file size, 6B ext, then the body.
        """
        cmd = (StorageCmd.UPLOAD_APPENDER_FILE if appender
               else StorageCmd.UPLOAD_FILE)
        fixed = bytes([store_path_index]) + long2buff(len(data)) + pack_ext_name(ext)
        self.conn.send_request(cmd, fixed + data)
        return _parse_upload_response(self.conn.recv_response("upload"))

    def upload_stream(self, fh, size: int, ext: str = "",
                      store_path_index: int = AUTO_STORE_PATH,
                      appender: bool = False,
                      segment: int = UPLOAD_SEGMENT_BYTES) -> str:
        """Upload ``size`` bytes read from file object ``fh`` in bounded
        segments — a multi-GB upload holds O(segment) client memory, not
        O(file) (the body streams through ``conn.send_request``'s
        iterable-body path)."""
        cmd = (StorageCmd.UPLOAD_APPENDER_FILE if appender
               else StorageCmd.UPLOAD_FILE)
        fixed = bytes([store_path_index]) + long2buff(size) + pack_ext_name(ext)

        def gen():
            yield fixed
            remaining = size
            while remaining > 0:
                seg = fh.read(min(segment, remaining))
                if not seg:
                    # Short source: the declared pkg_len cannot be
                    # amended mid-stream; send_request flags the
                    # connection broken and raises.
                    return
                remaining -= len(seg)
                yield seg

        self.conn.send_request(cmd, gen(), body_len=len(fixed) + size)
        return _parse_upload_response(self.conn.recv_response("upload"))

    def upload_file(self, path: str, ext: str | None = None, **kw) -> str:
        if ext is None:
            ext = os.path.splitext(path)[1].lstrip(".")[:6]
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            return self.upload_stream(fh, size, ext=ext, **kw)

    # -- dedup-aware negotiated upload (UPLOAD_RECIPE / UPLOAD_CHUNKS) ----

    def upload_buffer_dedup(self, data: bytes, ext: str = "",
                            store_path_index: int = AUTO_STORE_PATH,
                            chunks: list[tuple[int, bytes]] | None = None,
                            stats: dict | None = None,
                            segment: int = UPLOAD_SEGMENT_BYTES) -> str:
        """Upload via the negotiated two-round-trip protocol: fingerprint
        locally, ask the daemon which chunks it lacks, ship only those.

        ``chunks`` short-circuits fingerprinting when the caller already
        has [(length, 20B raw sha1)] (FdfsClient computes it once for its
        dup-ratio estimate).  Falls back to a plain ``upload_buffer``
        transparently when the daemon has no chunk store (ENOTSUP), is
        too old to know the opcode (EINVAL), or the session fails
        mid-flight — same file ID semantics either way.  ``stats`` (if
        given) is updated with chunks_total / chunks_missing /
        bytes_sent / fallback for accounting and tests.
        """
        if chunks is None:
            chunks = [(fp.length, fp.digest)
                      for fp in fingerprint_buffer(data, device=self.device)]
        if stats is None:
            stats = {}
        stats.update(chunks_total=len(chunks), chunks_missing=len(chunks),
                     bytes_sent=len(data), fallback="")
        if not chunks:  # empty payload: nothing to negotiate over
            stats["fallback"] = "empty"
            return self.upload_buffer(data, ext=ext,
                                      store_path_index=store_path_index)
        body = pack_upload_recipe(store_path_index, ext, zlib.crc32(data),
                                  len(data), chunks)
        if len(body) > MAX_INLINE_BODY:
            # The daemon refuses (connection close, no status) inline
            # bodies over the wire cap; a ~19 GB payload at the default
            # chunk size gets there.  Gate locally and fall back.
            stats["fallback"] = "recipe_too_large"
            return self.upload_buffer(data, ext=ext,
                                      store_path_index=store_path_index)
        try:
            self.conn.send_request(StorageCmd.UPLOAD_RECIPE, body)
            resp = self.conn.recv_response("upload_recipe")
        except StatusError as e:
            if e.status in _DEDUP_FALLBACK_STATUSES:
                stats["fallback"] = f"status{e.status}"
                return self.upload_buffer(data, ext=ext,
                                          store_path_index=store_path_index)
            raise
        session, needed = unpack_upload_recipe_resp(resp, len(chunks))

        spans: list[tuple[int, int]] = []  # (offset, length) to ship
        payload_len = 0
        offset = 0
        missing = 0
        for (length, _), need in zip(chunks, needed):
            if need:
                spans.append((offset, length))
                payload_len += length
                missing += 1
            offset += length

        def gen():
            yield pack_upload_chunks_prefix(session, payload_len)
            for off, length in spans:
                # Bounded segments even when one span is huge (max chunk
                # is 8 MB, but keep the discipline uniform).
                end = off + length
                while off < end:
                    yield data[off:min(off + segment, end)]
                    off = min(off + segment, end)

        try:
            self.conn.send_request(StorageCmd.UPLOAD_CHUNKS, gen(),
                                   body_len=16 + payload_len)
            body = self.conn.recv_response("upload_chunks")
        except StatusError as e:
            # Session expired / chunk vanished mid-commit: the daemon
            # rolled back; re-send the whole payload the classic way.
            # Honest wire accounting: the failed attempt's payload bytes
            # DID cross the wire on top of the plain re-send.
            stats.update(fallback=f"commit_status{e.status}",
                         chunks_missing=missing,
                         bytes_sent=payload_len + len(data))
            return self.upload_buffer(data, ext=ext,
                                      store_path_index=store_path_index)
        stats.update(chunks_missing=missing, bytes_sent=payload_len)
        return _parse_upload_response(body)

    def upload_slave_buffer(self, master_id: str, prefix: str, data: bytes,
                            ext: str = "") -> str:
        """Upload a derived file addressed by the master's ID + a prefix
        (reference storage_upload_slave_file, cmd 21): the slave lands at
        ``<master stem><prefix>.<ext>`` so clients can reconstruct its ID
        from the master ID alone.

        Wire: 16B group + 8B master_len + 8B size + 16B prefix + 6B ext +
        master_name + body.
        """
        group, remote = _split_id(master_id)
        name = remote.encode()
        body = (pack_group_name(group) + long2buff(len(name))
                + long2buff(len(data)) + pack_prefix_name(prefix)
                + pack_ext_name(ext) + name + data)
        self.conn.send_request(StorageCmd.UPLOAD_SLAVE_FILE, body)
        return _parse_upload_response(self.conn.recv_response("upload_slave"))

    # -- appender-file mutations -------------------------------------------

    def append_buffer(self, file_id: str, data: bytes) -> None:
        """Append bytes to an appender file (cmd APPEND_FILE).

        Wire: 16B group + 8B name_len + 8B length + name + body.
        """
        group, remote = _split_id(file_id)
        name = remote.encode()
        body = (pack_group_name(group) + long2buff(len(name))
                + long2buff(len(data)) + name + data)
        self.conn.send_request(StorageCmd.APPEND_FILE, body)
        self.conn.recv_response("append")

    def modify_buffer(self, file_id: str, offset: int, data: bytes) -> None:
        """Overwrite bytes at ``offset`` inside an appender file (MODIFY_FILE).

        Wire: 16B group + 8B name_len + 8B offset + 8B length + name + body.
        """
        group, remote = _split_id(file_id)
        name = remote.encode()
        body = (pack_group_name(group) + long2buff(len(name))
                + long2buff(offset) + long2buff(len(data)) + name + data)
        self.conn.send_request(StorageCmd.MODIFY_FILE, body)
        self.conn.recv_response("modify")

    def truncate_file(self, file_id: str, new_size: int = 0) -> None:
        """Truncate an appender file to ``new_size`` (TRUNCATE_FILE).

        Wire: 16B group + 8B name_len + 8B new_size + name.
        """
        group, remote = _split_id(file_id)
        name = remote.encode()
        body = (pack_group_name(group) + long2buff(len(name))
                + long2buff(new_size) + name)
        self.conn.send_request(StorageCmd.TRUNCATE_FILE, body)
        self.conn.recv_response("truncate")

    # -- downloads ---------------------------------------------------------

    def _send_download(self, file_id: str, offset: int, length: int) -> None:
        group, remote = _split_id(file_id)
        body = (long2buff(offset) + long2buff(length)
                + pack_group_name(group) + remote.encode())
        self.conn.send_request(StorageCmd.DOWNLOAD_FILE, body)

    def download_to_buffer(self, file_id: str, offset: int = 0,
                           length: int = 0) -> bytes:
        """Download (part of) a file.  length 0 = to EOF."""
        self._send_download(file_id, offset, length)
        return self.conn.recv_response("download")

    def download_stream(self, file_id: str, fh, offset: int = 0,
                        length: int = 0,
                        segment: int = UPLOAD_SEGMENT_BYTES) -> int:
        """Download (part of) a file into file object ``fh`` in bounded
        recv_into segments — O(segment) client memory however large the
        file (the download-side mirror of ``upload_stream``).  Returns
        the byte count written."""
        self._send_download(file_id, offset, length)
        return self.conn.recv_response_stream(fh, "download", segment)

    def download_into(self, file_id: str, mv, offset: int = 0) -> None:
        """Download EXACTLY len(mv) bytes at ``offset`` into a writable
        buffer (memoryview/bytearray) — the zero-copy worker primitive of
        the parallel ranged download (each worker lands its range
        directly in its slice of the shared output buffer)."""
        mv = memoryview(mv)
        self._send_download(file_id, offset, len(mv))
        self.conn.recv_response_into(mv, "download")

    def download_to_file(self, file_id: str, local_path: str,
                         offset: int = 0, length: int = 0) -> int:
        # Stream into a temp file and rename on success: a failed or
        # interrupted download must not truncate an existing local file
        # or leave a silently-partial one.
        tmp = f"{local_path}.part{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                n = self.download_stream(file_id, fh, offset, length)
            os.replace(tmp, local_path)
            return n
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- delete / info -----------------------------------------------------

    def delete_file(self, file_id: str) -> None:
        group, remote = _split_id(file_id)
        self.conn.send_request(StorageCmd.DELETE_FILE,
                               pack_group_name(group) + remote.encode())
        self.conn.recv_response("delete")

    def query_file_info(self, file_id: str) -> RemoteFileInfo:
        group, remote = _split_id(file_id)
        self.conn.send_request(StorageCmd.QUERY_FILE_INFO,
                               pack_group_name(group) + remote.encode())
        body = self.conn.recv_response("query_file_info")
        if len(body) < 40:
            raise ProtocolError(f"short query response: {len(body)}")
        return RemoteFileInfo(
            file_size=buff2long(body, 0),
            create_timestamp=buff2long(body, 8),
            crc32=buff2long(body, 16) & 0xFFFFFFFF,
            source_ip=body[24:40].rstrip(b"\x00").decode(),
        )

    def near_dups(self, file_id: str) -> list[tuple[str, float]]:
        """Ranked near-duplicates of a stored file from the dedup
        engine's MinHash/LSH index (fastdfs_tpu extension, NEAR_DUPS=124).
        Returns [] when the file carries no signature (ENODATA);
        StatusError(95) when the dedup mode has no near index."""
        group, remote = _split_id(file_id)
        self.conn.send_request(StorageCmd.NEAR_DUPS,
                               pack_group_name(group) + remote.encode())
        try:
            body = self.conn.recv_response("near_dups")
        except StatusError as e:
            if e.status == 61:  # ENODATA: indexed mode, unindexed file
                return []
            raise
        out: list[tuple[str, float]] = []
        for line in body.decode("utf-8", "replace").splitlines():
            parts = line.rsplit(" ", 1)
            if len(parts) == 2:
                try:
                    out.append((parts[0], float(parts[1])))
                except ValueError:
                    continue
        return out

    # -- metadata ----------------------------------------------------------

    def set_metadata(self, file_id: str, meta: dict[str, str],
                     merge: bool = False) -> None:
        group, remote = _split_id(file_id)
        flag = b"M" if merge else b"O"
        name = remote.encode()
        body = (pack_group_name(group) + flag + long2buff(len(name)) + name
                + pack_metadata(meta))
        self.conn.send_request(StorageCmd.SET_METADATA, body)
        self.conn.recv_response("set_metadata")

    def get_metadata(self, file_id: str) -> dict[str, str]:
        group, remote = _split_id(file_id)
        self.conn.send_request(StorageCmd.GET_METADATA,
                               pack_group_name(group) + remote.encode())
        return unpack_metadata(self.conn.recv_response("get_metadata"))

    # -- misc --------------------------------------------------------------

    def active_test(self) -> bool:
        self.conn.send_request(StorageCmd.ACTIVE_TEST)
        self.conn.recv_response("active_test")
        return True

    def stat(self) -> dict:
        """Stats-registry snapshot (STAT 130): per-opcode counters and
        latency histograms, dedup/replication/recovery accounting.  Shape
        per fastdfs_tpu.monitor.decode_registry."""
        self.conn.send_request(StorageCmd.STAT)
        return json.loads(self.conn.recv_response("stat") or b"{}")

    def trace_dump(self) -> dict:
        """Span ring-buffer dump (TRACE_DUMP 131): this daemon's retained
        request/replication/recovery spans.  Shape per
        fastdfs_tpu_torch.trace.decode_dump."""
        self.conn.send_request(StorageCmd.TRACE_DUMP)
        return json.loads(self.conn.recv_response("trace_dump") or b"{}")

    def event_dump(self) -> dict:
        """Flight-recorder dump (EVENT_DUMP 137): this daemon's retained
        structured cluster events (quarantines, GC sweeps, session
        expiries, stalls, slow requests).  Shape per
        fastdfs_tpu.monitor.decode_events."""
        self.conn.send_request(StorageCmd.EVENT_DUMP)
        return json.loads(self.conn.recv_response("event_dump") or b"{}")

    def metrics_history(self, since_us: int = 0) -> dict:
        """Metrics-journal window dump (METRICS_HISTORY 138): every
        retained registry snapshot with ts_us >= ``since_us`` (0 = the
        whole ring — including snapshots from BEFORE the daemon's last
        restart, which is the point).  Shape per
        fastdfs_tpu.monitor.decode_metrics_history; StatusError(95)
        when journaling is off (metrics_journal_mb = 0)."""
        body = long2buff(since_us) if since_us else b""
        self.conn.send_request(StorageCmd.METRICS_HISTORY, body)
        return json.loads(self.conn.recv_response("metrics_history") or b"{}")

    def heat_top(self, k: int = 0) -> dict:
        """Hot-file top-K dump (HEAT_TOP 139): the daemon's
        space-saving sketch ranked by request count, with per-op
        request/byte splits.  k=0 uses the daemon's heat_top_k.  Shape
        per fastdfs_tpu.monitor.decode_heat; StatusError(95) when the
        sketch is off (heat_top_k = 0)."""
        body = long2buff(k) if k else b""
        self.conn.send_request(StorageCmd.HEAT_TOP, body)
        return json.loads(self.conn.recv_response("heat_top") or b"{}")

    def health_status(self) -> dict:
        """Gray-failure health view (HEALTH_STATUS 146): this daemon's
        own gray score (watchdog stalls + disk-path probes) and its
        per-(peer, op class) RPC health table.  Shape per
        fastdfs_tpu.monitor.decode_health_status."""
        self.conn.send_request(StorageCmd.HEALTH_STATUS)
        return json.loads(self.conn.recv_response("health_status") or b"{}")

    def admission_status(self) -> dict:
        """Admission-ladder status (ADMISSION_STATUS 148): current shed
        level, pressure EWMA, per-class shed counts.  Shape per
        fastdfs_tpu.monitor.decode_admission."""
        self.conn.send_request(StorageCmd.ADMISSION_STATUS)
        return json.loads(self.conn.recv_response("admission_status")
                          or b"{}")

    def scrub_status(self) -> dict[str, int]:
        """Integrity-engine status (SCRUB_STATUS 134): named scrub/GC
        counters decoded from the fixed int64 blob (SCRUB_STAT_FIELDS).
        StatusError(95) when the daemon has no chunk store to scrub."""
        self.conn.send_request(StorageCmd.SCRUB_STATUS)
        return unpack_scrub_stats(self.conn.recv_response("scrub_status"))

    def scrub_kick(self) -> None:
        """Force a verify+repair+GC pass now (SCRUB_KICK 135) — works
        even when periodic scrubbing (scrub_interval_s) is off."""
        self.conn.send_request(StorageCmd.SCRUB_KICK)
        self.conn.recv_response("scrub_kick")

    def ec_status(self) -> dict[str, int]:
        """Erasure-coding cold-tier status (EC_STATUS 143): named stripe/
        demotion/reconstruction counters decoded from the fixed int64
        blob (EC_STAT_FIELDS).  StatusError(95) when EC is off
        (ec_k = 0) AND no stripes survive on disk — a drained daemon
        still answers so operators can watch the drain finish."""
        self.conn.send_request(StorageCmd.EC_STATUS)
        return unpack_ec_stats(self.conn.recv_response("ec_status"))

    def ec_kick(self) -> None:
        """Force an EC demotion pass now (EC_KICK 144): the next scrub
        pass treats ec_demote_age_s as 0 so every demotable cold chunk
        stripes immediately — then kick the scrubber itself.
        StatusError(95) when EC is off (ec_k = 0)."""
        self.conn.send_request(StorageCmd.EC_KICK)
        self.conn.recv_response("ec_kick")

    def profile_start(self, hz: int = 97, duration_s: int = 30) -> dict:
        """Arm the in-daemon sampling profiler (PROFILE_CTL 141) for
        ``duration_s`` seconds at ``hz`` samples/s (clamped to the
        daemon's profile_max_hz).  The daemon auto-disarms at the
        deadline, so a dropped connection cannot leave the timer armed.
        Returns the ack {"active": true, "hz": <armed hz>};
        StatusError(95) when profiling is off (profile_max_hz = 0)."""
        self.conn.send_request(StorageCmd.PROFILE_CTL,
                               pack_profile_ctl(True, hz, duration_s))
        return json.loads(self.conn.recv_response("profile_start") or b"{}")

    def profile_stop(self) -> dict:
        """Disarm the profiler early (PROFILE_CTL 141, action 0); the
        captured samples stay available to profile_dump.  Idempotent."""
        self.conn.send_request(StorageCmd.PROFILE_CTL,
                               pack_profile_ctl(False))
        return json.loads(self.conn.recv_response("profile_stop") or b"{}")

    def profile_dump(self) -> dict:
        """Folded-stack dump of the last capture (PROFILE_DUMP 142).
        Shape per fastdfs_tpu.monitor.decode_profile; StatusError(95)
        while no capture was ever started this daemon lifetime."""
        self.conn.send_request(StorageCmd.PROFILE_DUMP)
        return json.loads(self.conn.recv_response("profile_dump") or b"{}")


def _split_id(file_id: str) -> tuple[str, str]:
    group, sep, remote = file_id.partition("/")
    if not sep or not remote:
        raise ValueError(f"malformed file id: {file_id!r}")
    return group, remote
