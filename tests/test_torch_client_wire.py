"""The port's client wire code against the reference's, over the same
scripted fake servers.

Each scenario runs twice: once with ``fastdfs_tpu.client`` and once with
``fastdfs_tpu_torch.client`` (``device="cpu"``), each against fresh fake
tracker and storage daemons on localhost that answer from the same
script.  Every frame each client sends (prefix frames included) must be
equal, and so must every result, raised error type and status, and the
client's fallback counters.  Only the fakes' own TCP ports differ between
the two runs; results name them by role.  Tolerance: exact equality.
"""

import dataclasses
import hashlib
import io
import json
import os
import random
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from fastdfs_tpu.client import client as R_client
from fastdfs_tpu.client import conn as R_conn
from fastdfs_tpu.client import storage_client as R_storage
from fastdfs_tpu.client import tracker_client as R_tracker
from fastdfs_tpu_torch.client import client as T_client
from fastdfs_tpu_torch.client import conn as T_conn
from fastdfs_tpu_torch.client import storage_client as T_storage
from fastdfs_tpu_torch.client import tracker_client as T_tracker

_HDR = struct.Struct(">qBB")
_I64 = struct.Struct(">q")
PREFIX_CMDS = (140, 147)          # TRACE_CTX and PRIORITY: no response
GROUP = "group1"


def _g16(name: str) -> bytes:
    return name.encode().ljust(16, b"\0")


def _ip16(ip: str = "127.0.0.1") -> bytes:
    return ip.encode().ljust(16, b"\0")


def _recv_exact(conn, n):
    buf = bytearray()
    while len(buf) < n:
        try:
            got = conn.recv(n - len(buf))
        except OSError:
            return None
        if not got:
            return None
        buf += got
    return bytes(buf)


class FakeServer:
    """A scripted daemon on a localhost TCP port.  Records every frame it
    reads as (connection number, cmd, body); answers each request with
    ``answer(cmd, body)``: (status, body), or None to close the
    connection.  ``script[cmd]`` holds answers consumed before the normal
    one (an entry "close" drops the connection)."""

    def __init__(self, role: str):
        self.role = role
        self.frames: list[tuple[int, int, bytes]] = []
        self.script: dict[int, list] = {}
        self.conns = 0
        self._lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(32)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self._lock:
                idx = self.conns
                self.conns += 1
            threading.Thread(target=self._serve, args=(conn, idx),
                             daemon=True).start()

    def _serve(self, conn, idx):
        with conn:
            while True:
                hdr = _recv_exact(conn, 10)
                if hdr is None:
                    return
                n, cmd, _ = _HDR.unpack(hdr)
                body = _recv_exact(conn, n) if n else b""
                if body is None:
                    return
                with self._lock:
                    self.frames.append((idx, cmd, body))
                    queued = self.script.get(cmd)
                    ans = queued.pop(0) if queued else None
                if cmd in PREFIX_CMDS:
                    continue
                if ans is None:
                    ans = self.answer(cmd, body)
                if ans is None or ans == "close":
                    return
                status, resp = ans
                try:
                    conn.sendall(_HDR.pack(len(resp), 100, status) + resp)
                except OSError:
                    return

    def answer(self, cmd, body):
        return 22, b""

    def close(self):
        self.sock.close()


class FakeStorage(FakeServer):
    """Files, chunks and metadata in memory; ``files`` and ``chunks`` may
    be shared between replicas."""

    def __init__(self, files=None, chunks=None, group=GROUP):
        super().__init__("storage")
        self.group = group
        self.files = {} if files is None else files
        self.chunks = {} if chunks is None else chunks
        self.meta: dict[str, dict] = {}
        self.sessions: dict[int, tuple] = {}
        self.n = 0

    def _name(self, ext):
        self.n += 1
        return f"M00/00/{self.n:02X}/f{self.n:04d}" + (f".{ext}" if ext else "")

    def _store(self, data, ext):
        name = self._name(ext)
        self.files[name] = bytes(data)
        return 0, _g16(self.group) + name.encode()

    def answer(self, cmd, body):
        files = self.files
        if cmd in (11, 23):                     # UPLOAD_FILE, APPENDER
            size = _I64.unpack_from(body, 1)[0]
            ext = body[9:15].rstrip(b"\0").decode()
            data = body[15:]
            if len(data) != size:
                return 22, b""
            return self._store(data, ext)
        if cmd == 14:                           # DOWNLOAD_FILE
            off, ln = _I64.unpack_from(body, 0)[0], _I64.unpack_from(body, 8)[0]
            name = body[32:].decode()
            if name not in files:
                return 2, b""
            data = files[name]
            return 0, data[off:off + ln] if ln else data[off:]
        if cmd in (12, 15, 22, 124):            # by group + name
            name = body[16:].decode()
            if name not in files:
                return 2, b""
            if cmd == 12:
                del files[name]
                return 0, b""
            if cmd == 15:
                meta = self.meta.get(name, {})
                return 0, b"\x01".join(f"{k}\x02{v}".encode()
                                       for k, v in sorted(meta.items()))
            if cmd == 22:
                data = files[name]
                return 0, (_I64.pack(len(data)) + _I64.pack(1700000000)
                           + _I64.pack(zlib.crc32(data)) + _ip16())
            return 0, f"{GROUP}/{name}x 0.9000\nbad line\n".encode()
        if cmd == 13:                           # SET_METADATA
            nlen = _I64.unpack_from(body, 17)[0]
            name = body[25:25 + nlen].decode()
            pairs = body[25 + nlen:]
            meta = {} if body[16:17] == b"O" else dict(self.meta.get(name, {}))
            for rec in pairs.split(b"\x01") if pairs else []:
                k, _, v = rec.partition(b"\x02")
                meta[k.decode()] = v.decode()
            self.meta[name] = meta
            return 0, b""
        if cmd in (24, 34, 36):                 # APPEND, MODIFY, TRUNCATE
            nlen = _I64.unpack_from(body, 16)[0]
            if cmd == 24:
                ln = _I64.unpack_from(body, 24)[0]
                name = body[32:32 + nlen].decode()
                files[name] += body[32 + nlen:32 + nlen + ln]
            elif cmd == 34:
                off = _I64.unpack_from(body, 24)[0]
                name = body[40:40 + nlen].decode()
                data = body[40 + nlen:]
                old = files[name]
                files[name] = old[:off] + data + old[off + len(data):]
            else:
                size = _I64.unpack_from(body, 24)[0]
                name = body[32:32 + nlen].decode()
                files[name] = files[name][:size]
            return 0, b""
        if cmd == 21:                           # UPLOAD_SLAVE_FILE
            mlen = _I64.unpack_from(body, 16)[0]
            prefix = body[32:48].rstrip(b"\0").decode()
            ext = body[48:54].rstrip(b"\0").decode()
            master = body[54:54 + mlen].decode()
            stem = master.rsplit(".", 1)[0]
            name = stem + prefix + (f".{ext}" if ext else "")
            files[name] = body[54 + mlen:]
            return 0, _g16(self.group) + name.encode()
        if cmd == 132:                          # UPLOAD_RECIPE
            ext = body[1:7].rstrip(b"\0").decode()
            count = _I64.unpack_from(body, 23)[0]
            entries = [(body[31 + 28 * i:51 + 28 * i],
                        _I64.unpack_from(body, 51 + 28 * i)[0])
                       for i in range(count)]
            need = bytes(int(d not in self.chunks) for d, _ in entries)
            sid = 1000 + len(self.sessions)
            self.sessions[sid] = (ext, entries, need)
            return 0, _I64.pack(sid) + need
        if cmd == 133:                          # UPLOAD_CHUNKS
            sid = _I64.unpack_from(body, 0)[0]
            if sid not in self.sessions:
                return 2, b""
            ext, entries, need = self.sessions.pop(sid)
            pos, parts = 16, []
            for (digest, ln), nd in zip(entries, need):
                if nd:
                    piece = body[pos:pos + ln]
                    pos += ln
                    if hashlib.sha1(piece).digest() != digest:
                        return 22, b""
                    self.chunks[digest] = piece
                parts.append(self.chunks[digest])
            return self._store(b"".join(parts), ext)
        if cmd == 134:                          # SCRUB_STATUS
            return 0, b"".join(_I64.pack(i) for i in range(12))
        if cmd == 143:                          # EC_STATUS
            return 0, b"".join(_I64.pack(3 * i) for i in range(20))
        if cmd in (135, 144, 111):
            return 0, b""
        if cmd in (130, 131, 137, 138, 139, 141, 142, 146, 148):
            return 0, json.dumps({"cmd": cmd, "body": body.hex()}).encode()
        return 22, b""


class FakeTracker(FakeServer):
    """Routes every query to the storages it is given, in turn."""

    def __init__(self, storages, fetch=None, placement=None, hot=None,
                 leader=None):
        super().__init__("tracker")
        self.storages = storages
        self.fetch = fetch if fetch is not None else storages
        self.placement = placement
        self.hot = hot
        self.leader = leader
        self.rr = 0

    def _next(self, pool):
        s = pool[self.rr % len(pool)]
        self.rr += 1
        return s

    def answer(self, cmd, body):
        if cmd in (101, 104):                   # QUERY_STORE ONE
            s = self._next(self.storages)
            group = body[:16].rstrip(b"\0").decode() if cmd == 104 else s.group
            return 0, (_g16(group) + _ip16() + _I64.pack(s.port)
                       + bytes([0xFF]))
        if cmd in (102, 103):                   # QUERY_FETCH / UPDATE
            s = self._next(self.fetch)
            return 0, _ip16() + _I64.pack(s.port)
        if cmd in (105, 106, 107):              # target lists
            return 0, (_g16(GROUP) + bytes([0]) + _I64.pack(len(self.fetch))
                       + b"".join(_ip16() + _I64.pack(s.port)
                                  for s in self.fetch))
        if cmd == 64:                           # QUERY_PLACEMENT
            if self.placement is None:
                return 22, b""
            out = [_I64.pack(7), _I64.pack(len(self.placement))]
            for group, state, members in self.placement:
                out += [_g16(group), bytes([state]), _I64.pack(len(members))]
                out += [_ip16() + _I64.pack(m.port) for m in members]
            return 0, b"".join(out)
        if cmd == 75:                           # QUERY_HOT_MAP
            if self.hot is None:
                return 22, b""
            out = [_I64.pack(3), bytes([1]), _I64.pack(len(self.hot))]
            for key, groups in self.hot.items():
                out += [_I64.pack(len(key)), key.encode(),
                        _I64.pack(len(groups))] + [_g16(g) for g in groups]
            return 0, b"".join(out)
        if cmd == 70:                           # TRACKER_GET_STATUS
            lead = self.leader or self
            return 0, (bytes([int(lead is self)]) + _ip16()
                       + _I64.pack(lead.port))
        if cmd in (65, 66):                     # GROUP_DRAIN / REACTIVATE
            if self.leader is not None and self.leader is not self:
                return 16, b""
            return 0, _I64.pack(8 + cmd)
        if cmd in (93, 94, 111):
            if cmd == 94 and self.leader is not None and self.leader is not self:
                return 16, b""
            return 0, b""
        if cmd in (90, 91, 92, 95, 96, 97, 98, 69, 99, 148):
            return 0, json.dumps({"cmd": cmd, "body": body.hex(),
                                  "groups": []}).encode()
        if cmd == 76:
            return 0, b"a=1\nb=two\nbad\n"
        return 22, b""


def dead_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SIDES = {
    "reference": dict(client=R_client, storage=R_storage, tracker=R_tracker,
                      conn=R_conn, kw={}),
    "port": dict(client=T_client, storage=T_storage, tracker=T_tracker,
                 conn=T_conn, kw={"device": "cpu"}),
}


class Env:
    """One run's fakes, and the results the scenario reports."""

    def __init__(self, side):
        self.side = side
        self.servers: list[FakeServer] = []
        self.out: list = []

    def add(self, server):
        self.servers.append(server)
        return server

    def storage(self, **kw):
        return self.add(FakeStorage(**kw))

    def tracker(self, storages, **kw):
        return self.add(FakeTracker(storages, **kw))

    def fdfs(self, trackers, **kw):
        addrs = [t if isinstance(t, str) else f"127.0.0.1:{t.port}"
                 for t in trackers]
        return self.side["client"].FdfsClient(addrs, timeout=5.0,
                                              **kw, **self.side["kw"])

    def sc(self, server):
        return self.side["storage"].StorageClient(
            "127.0.0.1", server.port, timeout=5.0, **self.side["kw"])

    def rec(self, fn, *args, **kw):
        try:
            self.out.append(fn(*args, **kw))
        except Exception as e:  # noqa: BLE001 — the error is the result
            self.out.append(("raised", type(e).__name__,
                             getattr(e, "status", None),
                             getattr(e, "retry_after_ms", None)))
        return self.out[-1]

    def close(self):
        for s in self.servers:
            s.close()


def _norm(x, ports):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _norm(dataclasses.asdict(x), ports))
    if isinstance(x, dict):
        return {k: _norm(v, ports) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, ports) for v in x)
    if isinstance(x, int) and not isinstance(x, bool) and x in ports:
        return ports[x]
    if isinstance(x, str):
        for p, role in ports.items():
            x = x.replace(f":{p}", f":{role}")
    return x


def run_both(scenario, monkeypatch, ordered=True):
    """The scenario's results and frames on both sides, ports named."""
    runs = {}
    for name, side in SIDES.items():
        random.seed(1234)
        env = Env(side)
        try:
            with monkeypatch.context() as mp:
                scenario(env, mp)
        finally:
            env.close()
        ports = {s.port: f"{s.role}{i}" for i, s in enumerate(env.servers)}
        frames = [[(c, f) for _, c, f in s.frames] for s in env.servers]
        if not ordered:
            frames = [sorted(f) for f in frames]
        # Connections that carried a frame (a bare connect may still sit
        # in the listen backlog when the fakes close).
        conns = [len({i for i, _, _ in s.frames}) for s in env.servers]
        runs[name] = (_norm(env.out, ports), frames, conns)
    return runs["reference"], runs["port"]


def _payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# StorageClient against one storage daemon
# ---------------------------------------------------------------------------

def sc_upload_download_delete(env, mp):
    st = env.storage()
    data = _payload(1, 300_000)
    with env.sc(st) as sc:
        fid = env.rec(sc.upload_buffer, data, ext="bin")
        env.rec(sc.download_to_buffer, fid)
        env.rec(sc.download_to_buffer, fid, 1000, 4321)
        buf = bytearray(5000)
        env.rec(sc.download_into, fid, buf, 7)
        env.out.append(bytes(buf))
        env.rec(sc.query_file_info, fid)
        env.rec(sc.delete_file, fid)
        env.rec(sc.download_to_buffer, fid)
        env.rec(sc.delete_file, fid)
        env.rec(sc.download_to_buffer, "nogroup")


def sc_appender(env, mp):
    st = env.storage()
    with env.sc(st) as sc:
        fid = env.rec(sc.upload_buffer, b"hello", appender=True)
        env.rec(sc.append_buffer, fid, b" world")
        env.rec(sc.modify_buffer, fid, 1, b"EL")
        env.rec(sc.download_to_buffer, fid)
        env.rec(sc.truncate_file, fid, 4)
        env.rec(sc.download_to_buffer, fid)
        env.rec(sc.upload_slave_buffer, fid, "_small", b"thumb", "jpg")
        env.rec(sc.upload_slave_buffer, fid, "bad/prefix", b"x")


def sc_metadata(env, mp):
    st = env.storage()
    with env.sc(st) as sc:
        fid = env.rec(sc.upload_buffer, b"m" * 100, ext="txt")
        env.rec(sc.set_metadata, fid, {"w": "1024", "h": "768"})
        env.rec(sc.get_metadata, fid)
        env.rec(sc.set_metadata, fid, {"a": "b"}, merge=True)
        env.rec(sc.get_metadata, fid)
        env.rec(sc.set_metadata, fid, {"x": "y"})
        env.rec(sc.get_metadata, fid)
        env.rec(sc.set_metadata, fid, {"bad\x01": "y"})


def sc_streams(env, mp):
    st = env.storage()
    data = _payload(2, 700_001)
    tmp = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"wire{os.getpid()}.bin")
    with open(tmp, "wb") as fh:
        fh.write(data)
    try:
        with env.sc(st) as sc:
            fid = env.rec(sc.upload_stream, io.BytesIO(data), len(data),
                          ext="dat", segment=65536)
            env.rec(sc.upload_file, tmp)
            out = io.BytesIO()
            env.rec(sc.download_stream, fid, out, 5, 600_000, 100_000)
            env.out.append(out.getvalue())
            env.rec(sc.download_to_file, fid, tmp + ".out")
            with open(tmp + ".out", "rb") as fh:
                env.out.append(fh.read() == data)
        with env.sc(st) as sc:   # a short source breaks the stream
            env.rec(sc.upload_stream, io.BytesIO(data[:10]), 20)
            env.out.append(sc.conn.broken)
    finally:
        for p in (tmp, tmp + ".out"):
            if os.path.exists(p):
                os.unlink(p)


def sc_control(env, mp):
    st = env.storage()
    with env.sc(st) as sc:
        for fn in ("active_test", "stat", "trace_dump", "event_dump",
                   "health_status", "admission_status", "scrub_status",
                   "scrub_kick", "ec_status", "ec_kick", "profile_stop",
                   "profile_dump"):
            env.rec(getattr(sc, fn))
        env.rec(sc.metrics_history, 12345)
        env.rec(sc.heat_top, 5)
        env.rec(sc.profile_start, 50, 3)
        fid = env.rec(sc.upload_buffer, b"n" * 10)
        env.rec(sc.near_dups, fid)
        st.script[124] = [(61, b""), (95, b"")]
        env.rec(sc.near_dups, fid)
        env.rec(sc.near_dups, fid)


def sc_errors(env, mp):
    st = env.storage()
    st.script[11] = [(16, _I64.pack(250)), (16, b""), (0, b"short"),
                     (5, b"errbody")]
    with env.sc(st) as sc:
        for _ in range(4):
            env.rec(sc.upload_buffer, b"e" * 10)
        env.rec(sc.upload_buffer, b"ok")
        st.script[14] = ["close"]
        env.rec(sc.download_to_buffer, "group1/M00/00/01/f0005")
        env.out.append(sc.conn.broken)
    with env.sc(st) as sc:   # a body larger than the caller's buffer
        fid = env.rec(sc.upload_buffer, b"z" * 50)
        st.script[14] = [(0, b"z" * 60)]
        env.rec(sc.download_into, fid, bytearray(50))
        env.out.append(sc.conn.broken)


def sc_dedup_negotiated(env, mp):
    st = env.storage()
    base = _payload(3, 400_000)
    variant = base[:300_000] + _payload(4, 100_000)
    with env.sc(st) as sc:
        for data in (base, base, variant):
            stats = {}
            fid = env.rec(sc.upload_buffer_dedup, data, ext="bin",
                          stats=stats)
            env.out.append(stats)
            env.rec(sc.download_to_buffer, fid)
        chunks = [(100, hashlib.sha1(b"q" * 100).digest()),
                  (50, hashlib.sha1(b"r" * 50).digest())]
        stats = {}
        env.rec(sc.upload_buffer_dedup, b"q" * 100 + b"r" * 50, ext="x",
                chunks=chunks, stats=stats, segment=64)
        env.out.append(stats)


def _dedup_fallback(script):
    def scenario(env, mp):
        st = env.storage()
        st.script.update({k: list(v) for k, v in script.items()})
        data = _payload(5, 200_000)
        with env.sc(st) as sc:
            stats = {}
            fid = env.rec(sc.upload_buffer_dedup, data, stats=stats)
            env.out.append(stats)
            env.rec(sc.download_to_buffer, fid)
    return scenario


def sc_dedup_empty(env, mp):
    st = env.storage()
    with env.sc(st) as sc:
        stats = {}
        env.rec(sc.upload_buffer_dedup, b"", stats=stats)
        env.out.append(stats)


def sc_dedup_recipe_too_large(env, mp):
    mp.setattr(env.side["storage"], "MAX_INLINE_BODY", 64)
    st = env.storage()
    with env.sc(st) as sc:
        stats = {}
        env.rec(sc.upload_buffer_dedup, _payload(6, 100_000), stats=stats)
        env.out.append(stats)


def sc_dedup_bad_digest(env, mp):
    st = env.storage()
    with env.sc(st) as sc:
        env.rec(sc.upload_buffer_dedup, b"abc", chunks=[(3, b"short")])


def sc_codecs(env, mp):
    m = env.side["storage"]
    chunks = [(i + 1, hashlib.sha1(bytes([i])).digest()) for i in range(5)]
    env.out.append(m.pack_upload_recipe(3, "tar", 0x1FFFFFFFF, 15, chunks))
    env.out.append(m.pack_upload_chunks_prefix(77, 12345))
    env.out.append(m.unpack_upload_recipe_resp(_I64.pack(9) + b"\1\0\1", 3))
    env.rec(m.unpack_upload_recipe_resp, _I64.pack(9) + b"\1", 3)
    env.out.append((m.AUTO_STORE_PATH, m.UPLOAD_SEGMENT_BYTES,
                    m._DEDUP_FALLBACK_STATUSES))
    env.rec(m._split_id, "group1")
    env.rec(m._parse_upload_response, b"g" * 16)


# ---------------------------------------------------------------------------
# FdfsClient through a tracker
# ---------------------------------------------------------------------------

def fc_routed_ops(env, mp):
    st = env.storage()
    tr = env.tracker([st])
    cli = env.fdfs([tr])
    try:
        data = _payload(7, 150_000)
        fid = env.rec(cli.upload_buffer, data, ext="bin")
        env.rec(cli.upload_buffer, b"g2", group="group2")
        env.rec(cli.upload_buffer, b"k", key="user/42")
        env.rec(cli.download_to_buffer, fid)
        env.rec(cli.download_to_buffer, fid, 10, 20)
        env.rec(cli.query_file_info, fid)
        env.rec(cli.set_metadata, fid, {"k": "v"})
        env.rec(cli.get_metadata, fid)
        env.rec(cli.near_dups, fid)
        app = env.rec(cli.upload_appender_buffer, b"ab")
        env.rec(cli.append_buffer, app, b"cd")
        env.rec(cli.modify_buffer, app, 0, b"AB")
        env.rec(cli.truncate_file, app, 3)
        env.rec(cli.download_to_buffer, app)
        env.rec(cli.upload_slave_buffer, fid, "_s", b"slave", "txt")
        out = io.BytesIO()
        env.rec(cli.download_stream, fid, out)
        env.out.append(out.getvalue() == data)
        env.rec(cli.delete_file, fid)
        env.rec(cli.download_to_buffer, fid)
        env.out.append(cli.stats())
        env.out.append((cli.pool.hits, cli.pool.misses, cli.pool.idle_count()))
    finally:
        cli.close()


def fc_tracker_queries(env, mp):
    st = env.storage()
    tr = env.tracker([st])
    cli = env.fdfs([tr], use_pool=False)
    for fn, args in [("list_groups", ()), ("list_storages", (GROUP,)),
                     ("cluster_stat", ()), ("cluster_stat", (GROUP,)),
                     ("tracker_status", ()), ("health_matrix", ()),
                     ("tracker_admission_status", ()),
                     ("query_placement", ()), ("query_hot_map", (4,)),
                     ("delete_storage", (GROUP, "10.0.0.9", 23000)),
                     ("storage_stat", ("127.0.0.1", st.port)),
                     ("storage_events", ("127.0.0.1", st.port)),
                     ("storage_metrics_history", ("127.0.0.1", st.port, 9)),
                     ("storage_heat_top", ("127.0.0.1", st.port, 3)),
                     ("storage_health_status", ("127.0.0.1", st.port)),
                     ("storage_admission_status", ("127.0.0.1", st.port)),
                     ("storage_profile_start", ("127.0.0.1", st.port)),
                     ("storage_profile_stop", ("127.0.0.1", st.port)),
                     ("storage_profile_dump", ("127.0.0.1", st.port)),
                     ("scrub_status", ("127.0.0.1", st.port)),
                     ("scrub_kick", ("127.0.0.1", st.port)),
                     ("ec_status", ("127.0.0.1", st.port)),
                     ("ec_kick", ("127.0.0.1", st.port))]:
        env.rec(getattr(cli, fn), *args)
    t = env.side["tracker"].TrackerClient("127.0.0.1", tr.port, 5.0)
    with t:
        for fn in ("get_parameters", "stat", "event_dump", "trace_dump",
                   "profile_stop", "profile_dump", "active_test"):
            env.rec(getattr(t, fn))
        env.rec(t.metrics_history, 5)
        env.rec(t.profile_start, 10, 2)
        env.rec(t.query_store_all)
        env.rec(t.query_store_all, GROUP)
        env.rec(t.query_fetch_all, "group1/M00/00/01/f0001")
        env.rec(t.list_one_group, GROUP)
    tr.script[101] = [(0, b"short")]
    tr.script[102] = [(0, b"x")]
    tr.script[64] = [(0, b"1")]
    tr.script[75] = [(0, b"\0" * 9)]
    tr.script[70] = [(0, b"")]
    with env.side["tracker"].TrackerClient("127.0.0.1", tr.port, 5.0) as t:
        for fn in ("query_store", "query_placement", "query_hot_map",
                   "get_tracker_status"):
            env.rec(getattr(t, fn))
        env.rec(t.query_fetch, "group1/x")


def fc_tracker_failover(env, mp):
    st = env.storage()
    bad = env.tracker([st])
    good = env.tracker([st])
    bad.script[101] = ["close", "close"]
    bad.script[102] = ["close"]
    cli = env.fdfs([bad, good, f"127.0.0.1:{dead_port()}"])
    try:
        for i in range(4):
            env.rec(cli.upload_buffer, bytes([i]) * 10)
        env.rec(cli.download_to_buffer, "group1/M00/00/01/f0001")
        env.out.append(cli.stats())
        env.out.append(sorted(
            (h, p in (bad.port, good.port)) for h, p in cli.trackers
            if cli.pool.is_dead(h, p)))
    finally:
        cli.close()


def fc_status_not_failed_over(env, mp):
    st = env.storage()
    t1 = env.tracker([st])
    t2 = env.tracker([st])
    t1.script[102] = [(2, b"")]
    t2.script[102] = [(2, b"")]
    t1.script[103] = [(16, _I64.pack(1))]
    t2.script[103] = [(16, _I64.pack(1))]
    cli = env.fdfs([t1, t2], use_pool=False)
    env.rec(cli.download_to_buffer, "group1/nofile")
    fid = env.rec(cli.upload_buffer, b"x")
    env.rec(cli.delete_file, fid)
    env.out.append(cli.stats())


def fc_no_tracker(env, mp):
    cli = env.fdfs([f"127.0.0.1:{dead_port()}"])
    env.rec(cli.upload_buffer, b"x")
    env.out.append(cli.stats())
    for addrs in ([], ["nohost"], ["h:port"]):
        env.rec(env.side["client"].FdfsClient, addrs, **env.side["kw"])


def fc_placement(env, mp):
    st1 = env.storage()
    st2 = env.storage(group="group2")
    tr = env.tracker([st1], placement=[("group1", 0, [st1]),
                                       ("group2", 0, [st2]),
                                       ("group3", 1, [st1])])
    cli = env.fdfs([tr], use_placement=True)
    try:
        for key in ("alpha", "beta", "gamma", "delta", "eps"):
            env.rec(cli.upload_buffer, key.encode(), key=key)
        st2.script[11] = [(16, b"")]
        st1.script[11] = [(16, b"")]
        for key in ("alpha", "beta"):
            env.rec(cli.upload_buffer, key.encode(), key=key)
        env.out.append(cli.stats())
    finally:
        cli.close()


def fc_dedup_gates(env, mp):
    st = env.storage()
    tr = env.tracker([st])
    cli = env.fdfs([tr], dedup_uploads=True, dedup_min_bytes=4096,
                   dedup_min_ratio=0.5, dedup_digest_cache=64)
    try:
        data = _payload(8, 200_000)
        for payload, kw in [(b"tiny", {}), (data, {}), (data, {}),
                            (data, {"min_dup_ratio": 0}),
                            (_payload(9, 50_000), {"min_dup_ratio": 0.9})]:
            stats = {}
            fid = env.rec(cli.upload_buffer_dedup, payload, stats=stats, **kw)
            env.out.append(stats)
            env.rec(cli.download_to_buffer, fid)
        env.rec(cli.upload_buffer, data)     # dedup_uploads routes it
        env.rec(cli.upload_buffer, data, appender=True)
        st.script[132] = [(95, b"")]
        stats = {}
        env.rec(cli.upload_buffer_dedup, data, min_dup_ratio=0, stats=stats)
        env.out.append(stats)
        st.script[133] = [(2, b"")]
        stats = {}
        env.rec(cli.upload_buffer_dedup, _payload(10, 100_000),
                min_dup_ratio=0, stats=stats)
        env.out.append(stats)
        env.out.append(cli.stats())
        env.out.append(len(cli._seen_digests))
    finally:
        cli.close()


def fc_admission(env, mp):
    mp.setattr(env.side["client"].time, "sleep", lambda s: None)
    st = env.storage()
    tr = env.tracker([st])
    cli = env.fdfs([tr], admission_retries=2, priority=3)
    try:
        st.script[11] = [(16, _I64.pack(5)), (16, _I64.pack(5))]
        env.rec(cli.upload_buffer, b"a")
        st.script[11] = [(16, _I64.pack(5))] * 3
        env.rec(cli.upload_buffer, b"b")
        st.script[11] = [(16, b"")]
        env.rec(cli.upload_buffer, b"c")
        tr.script[101] = [(16, _I64.pack(2))]
        env.rec(cli.upload_buffer, b"d")
        env.out.append(cli.stats())
    finally:
        cli.close()


def fc_parallel_ranged(env, mp):
    files, chunks = {}, {}
    st1 = env.storage(files=files, chunks=chunks)
    st2 = env.storage(files=files, chunks=chunks)
    tr = env.tracker([st1], fetch=[st1, st2])
    data = _payload(11, 600_000)
    files["M00/00/01/big.bin"] = data
    fid = "group1/M00/00/01/big.bin"
    cli = env.fdfs([tr], parallel_downloads=4, download_range_bytes=65536,
                   hot_routing=False)
    try:
        env.rec(cli.download_to_buffer, fid)
        env.rec(cli.download_to_buffer, fid, 100_000, 300_000)
        env.rec(cli.download_ranged, fid, 0, 50_000)
        env.rec(cli.download_ranged, fid, parallel=1)
        out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                           f"ranged{os.getpid()}.bin")
        env.rec(cli.download_to_file, fid, out)
        with open(out, "rb") as fh:
            env.out.append(fh.read() == data)
        os.unlink(out)
        st2.script[14] = ["close"]
        env.rec(cli.download_to_buffer, fid)
        env.out.append(cli.stats())
    finally:
        cli.close()


def fc_hot_routing(env, mp):
    files = {}
    st1 = env.storage(files=files)
    st2 = env.storage(files=files, group="group2")
    files["M00/00/01/hot.bin"] = b"hot" * 100
    fid = "group1/M00/00/01/hot.bin"
    tr = env.tracker([st1], hot={fid: ["group2"]},
                     placement=[("group1", 0, [st1]), ("group2", 0, [st2])])
    cli = env.fdfs([tr], hot_map_ttl_s=3600.0)    # one map fetch, however slow
    try:
        for _ in range(8):
            env.rec(cli.download_to_buffer, fid)
        st2.script[14] = [(2, b"")] * 8
        for _ in range(6):
            env.rec(cli.download_to_buffer, fid)
        env.out.append(cli.stats())
        env.rec(cli.query_hot_map)
    finally:
        cli.close()


def fc_leader_calls(env, mp):
    st = env.storage()
    leader = env.tracker([st])
    follower = env.tracker([st], leader=leader)
    cli = env.fdfs([follower], use_pool=False)
    env.rec(cli.set_trunk_server, GROUP, "10.0.0.2", 23000)
    env.rec(cli.group_drain, GROUP)
    env.rec(cli.group_reactivate, GROUP)
    leader.script[65] = [(22, b"")]
    env.rec(cli.group_drain, GROUP)


def fc_pool_reuse_and_cooldown(env, mp):
    st = env.storage()
    tr = env.tracker([st])
    cli = env.fdfs([tr], dead_peer_cooldown_s=60.0)
    try:
        for i in range(5):
            env.rec(cli.upload_buffer, bytes([i]))
        env.out.append((cli.pool.hits, cli.pool.misses,
                        cli.pool.idle_count(), cli.pool.in_use_count()))
        pool = env.side["conn"].ConnectionPool(dead_peer_cooldown=60.0)
        pool.mark_dead("127.0.0.1", 1)
        env.out.append((pool.is_dead("127.0.0.1", 1),
                        pool.is_dead("127.0.0.1", 2), pool.dead_mark_count()))
        conn = pool.acquire("127.0.0.1", st.port, 5.0)
        conn.priority = 2
        pool.release(conn)
        pool.release(conn)                      # double release: parked once
        env.out.append((pool.idle_count(), conn.priority, conn.trace_ctx))
        again = pool.acquire("127.0.0.1", st.port, 5.0)
        env.out.append(again is conn)
        again.broken = True
        pool.release(again)
        env.out.append(pool.idle_count())
        pool.mark_dead("127.0.0.1", st.port)
        pool.release(pool.acquire("127.0.0.1", st.port, 5.0))
        env.out.append(pool.is_dead("127.0.0.1", st.port))
        pool.sweep(now=10 ** 9)
        env.out.append((pool.idle_count(), pool.dead_mark_count(),
                        pool.swept_idle))
        pool.close_all()
    finally:
        cli.close()


def fc_from_conf(env, mp):
    st = env.storage()
    tr = env.tracker([st])
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"client{os.getpid()}.conf")
    with open(path, "w") as fh:
        fh.write(f"tracker_server = 127.0.0.1:{tr.port}\n"
                 "network_timeout = 7\nuse_connection_pool = false\n"
                 "dedup_uploads = true\ndedup_min_bytes = 8K\n"
                 "dedup_min_ratio = 0.25\nparallel_downloads = 3\n"
                 "download_range_bytes = 1M\nuse_placement = true\n"
                 "request_priority = 2\nadmission_retries = 4\n"
                 "hot_routing = false\nhot_map_ttl_s = 9\n")
    try:
        cli = env.side["client"].FdfsClient.from_conf(path,
                                                      **env.side["kw"])
    finally:
        os.unlink(path)
    env.out.append({k: v for k, v in vars(cli).items()
                    if isinstance(v, (int, float, str, bool, list, type(None)))
                    and k != "device"})
    env.rec(cli.upload_buffer, b"conf")


SCENARIOS = {
    "storage_upload_download_delete": sc_upload_download_delete,
    "storage_appender_and_slave": sc_appender,
    "storage_metadata": sc_metadata,
    "storage_streams": sc_streams,
    "storage_control_plane": sc_control,
    "storage_status_errors": sc_errors,
    "dedup_negotiated": sc_dedup_negotiated,
    "dedup_fallback_status22": _dedup_fallback({132: [(22, b"")]}),
    "dedup_fallback_status95": _dedup_fallback({132: [(95, b"")]}),
    "dedup_recipe_status_other": _dedup_fallback({132: [(5, b"")]}),
    "dedup_commit_failure": _dedup_fallback({133: [(2, b"")]}),
    "dedup_empty": sc_dedup_empty,
    "dedup_recipe_too_large": sc_dedup_recipe_too_large,
    "dedup_bad_digest": sc_dedup_bad_digest,
    "storage_codecs": sc_codecs,
    "client_routed_ops": fc_routed_ops,
    "client_tracker_queries": fc_tracker_queries,
    "client_tracker_failover": fc_tracker_failover,
    "client_status_not_failed_over": fc_status_not_failed_over,
    "client_no_tracker": fc_no_tracker,
    "client_placement_routing": fc_placement,
    "client_dedup_gates": fc_dedup_gates,
    "client_admission_retry": fc_admission,
    "client_leader_calls": fc_leader_calls,
    "client_pool_reuse_and_cooldown": fc_pool_reuse_and_cooldown,
    "client_from_conf": fc_from_conf,
    "client_hot_routing": fc_hot_routing,
}

# Threads make the order of frames across connections vary; these
# compare each server's frames as a multiset.
UNORDERED = {"client_parallel_ranged": fc_parallel_ranged}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name, monkeypatch):
    ref, port = run_both(SCENARIOS[name], monkeypatch)
    assert port[0] == ref[0]            # results and errors
    assert port[1] == ref[1]            # every frame, in order
    assert port[2] == ref[2]            # connections opened
    assert ref[0], "the scenario recorded nothing"


@pytest.mark.parametrize("name", sorted(UNORDERED))
def test_threaded_scenario_equals_reference(name, monkeypatch):
    ref, port = run_both(UNORDERED[name], monkeypatch, ordered=False)
    assert port[0] == ref[0]
    assert port[1] == ref[1]


def test_fake_sees_the_negotiated_upload_bytes(monkeypatch):
    """The comparison above is not vacuous: the port's client really
    sends the recipe, ships only the missing chunks and reads back the
    data, on its CPU fingerprint route."""
    env = Env(SIDES["port"])
    try:
        st = env.storage()
        data = _payload(12, 300_000)
        with env.sc(st) as sc:
            first, second = {}, {}
            fid = sc.upload_buffer_dedup(data, stats=first)
            sc.upload_buffer_dedup(data, stats=second)
            assert sc.download_to_buffer(fid) == data
        assert first["fallback"] == second["fallback"] == ""
        assert first["bytes_sent"] == len(data)
        assert second["bytes_sent"] == 0 and second["chunks_missing"] == 0
        cmds = [c for _, c, _ in st.frames]
        assert cmds == [132, 133, 132, 133, 14]
    finally:
        env.close()

