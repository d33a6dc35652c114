"""Low-level framed connection + connection pool: the port's copy of
``fastdfs_tpu/client/conn.py`` (reference:
libfastcommon sockopt.c tcprecvdata_nb/tcpsenddata_nb, fdfs_proto.c
fdfs_recv_response, and connection_pool.c for the pooling)."""

from __future__ import annotations

import select
import socket
import threading
import time
from collections import deque

from fastdfs_tpu_torch.common.protocol import (HEADER_SIZE, Header,
                                               pack_header, priority_frame,
                                               unpack_header,
                                               unpack_retry_after)


class ProtocolError(Exception):
    pass


class StatusError(ProtocolError):
    """Non-zero status byte in a response header.

    ``retry_after_ms``: for EBUSY (16) refusals from the admission
    ladder the daemon's error body carries a retry-after hint; 0 for
    every other status (and for EBUSY sources that predate the hint —
    max_connections refusals, drain refusals)."""

    def __init__(self, status: int, context: str = "",
                 retry_after_ms: int = 0):
        self.status = status
        self.retry_after_ms = retry_after_ms
        super().__init__(f"server returned status {status}"
                         + (f" ({context})" if context else ""))


class Connection:
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host, self.port = host, port
        self.timeout = timeout
        # Set on any mid-message failure: the stream cannot be resynced,
        # so a pool must discard rather than reuse this connection.
        self.broken = False
        # Distributed tracing: when set (a trace.TraceContext), every
        # request is prefixed with its TRACE_CTX frame so the
        # daemon's spans stitch into the trace.  Sticky until cleared;
        # the pool clears it on release so a parked connection never
        # leaks one caller's trace onto the next.
        self.trace_ctx = None
        # Request QoS: when set (a PriorityClass int), every request is
        # prefixed with its 1-byte PRIORITY frame so the daemon's
        # admission ladder knows the class (untagged requests get an
        # opcode-derived default server-side).  Sticky like trace_ctx —
        # the daemon consumes one tag per request, so the frame is
        # re-sent each time — and cleared by the pool on release.
        self.priority = None
        self.sock = self._connect()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- framing -----------------------------------------------------------

    def send_request(self, cmd: int, body: bytes = b"",
                     body_len: int | None = None) -> None:
        """Send one framed request.

        ``body`` is either bytes, or an ITERABLE of bytes segments (then
        ``body_len`` — the total — is required): multi-GB uploads stream
        through in bounded segments instead of materializing in memory.
        """
        # The server closes a connection after an error response that left
        # request bytes unread (it cannot resync mid-stream).  A request
        # boundary is the one safe place to reconnect, so retry once — the
        # same recovery the reference's connection pool performs.
        streaming = not isinstance(body, (bytes, bytearray, memoryview))
        if streaming and body_len is None:
            raise ValueError("iterable body requires body_len")
        hdr = pack_header((len(body) if body_len is None else body_len), cmd)
        if self.trace_ctx is not None:
            # Prefix frame first: the daemon stashes the context and
            # applies it to this request (it sends no response of its
            # own, so request/response pairing is unchanged).
            hdr = self.trace_ctx.frame() + hdr
        if self.priority is not None:
            # Same prefix-frame discipline for the QoS class byte.
            hdr = priority_frame(self.priority) + hdr
        first = hdr if streaming else hdr + bytes(body)
        try:
            self.sock.sendall(first)
        except OSError:
            # Nothing of a streamed body has been consumed yet (only the
            # header went to the dead socket), so a single reconnect is
            # still safe for both shapes.
            self.close()
            self.sock = self._connect()
            self.broken = False
            try:
                self.sock.sendall(first)
            except OSError:
                self.broken = True
                raise
        if streaming:
            # Past the header there is no safe resend point: a partially
            # streamed body on a reconnected socket would desync framing.
            # ANY failure — socket error or the source iterable raising
            # (e.g. a closed file wrapper) — marks the connection broken
            # so the pool can never re-issue the desynced stream.
            sent = 0
            try:
                for seg in body:
                    if seg:
                        self.sock.sendall(seg)
                        sent += len(seg)
            except BaseException:
                self.broken = True
                raise
            if sent != body_len:
                self.broken = True
                raise ProtocolError(
                    f"streaming body produced {sent} bytes, "
                    f"declared {body_len}")

    def send_raw(self, data: bytes) -> None:
        try:
            self.sock.sendall(data)
        except OSError:
            self.broken = True
            raise

    def recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            try:
                chunk = self.sock.recv(min(n - got, 256 * 1024))
            except OSError:
                self.broken = True
                raise
            if not chunk:
                self.broken = True
                raise ProtocolError("connection closed mid-message")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def recv_exact_into(self, mv: memoryview) -> None:
        """Fill a writable buffer with exactly len(mv) bytes via
        recv_into — no intermediate bytes objects, so a large download
        costs one copy (kernel -> caller buffer) instead of three."""
        got = 0
        n = len(mv)
        while got < n:
            try:
                k = self.sock.recv_into(mv[got:], n - got)
            except OSError:
                self.broken = True
                raise
            if k == 0:
                self.broken = True
                raise ProtocolError("connection closed mid-message")
            got += k

    def recv_header(self) -> Header:
        return unpack_header(self.recv_exact(HEADER_SIZE))

    def recv_response(self, context: str = "") -> bytes:
        """Header + body; raises StatusError on non-zero status.

        Large bodies (>= 1 MB) are received straight into one
        preallocated buffer via recv_into — the chunk-list-and-join path
        costs an extra full copy plus per-piece overhead that capped
        downloads well below the wire rate."""
        hdr = self.recv_header()
        if hdr.status != 0:
            self._raise_status(hdr, context)
        if not hdr.pkg_len:
            return b""
        if hdr.pkg_len >= (1 << 20):
            buf = bytearray(hdr.pkg_len)
            self.recv_exact_into(memoryview(buf))
            return bytes(buf)
        return self.recv_exact(hdr.pkg_len)

    def _raise_status(self, hdr: Header, context: str) -> None:
        # Error responses may carry a (small) body; drain it so the
        # connection stays framed and reusable.  An EBUSY body is the
        # admission ladder's 8-byte retry-after hint — surface it on
        # the exception (unpack_retry_after answers 0 for the short or
        # absent bodies older EBUSY sources send).
        body = self.recv_exact(hdr.pkg_len) if hdr.pkg_len else b""
        raise StatusError(hdr.status, context,
                          retry_after_ms=(unpack_retry_after(body)
                                          if hdr.status == 16 else 0))

    def recv_response_into(self, mv: memoryview, context: str = "") -> None:
        """Response whose body lands in a caller buffer of EXACTLY the
        expected size (ranged downloads know their length up front).  A
        size mismatch is a framing violation: the connection is marked
        broken (the unread tail cannot be resynced)."""
        hdr = self.recv_header()
        if hdr.status != 0:
            self._raise_status(hdr, context)
        if hdr.pkg_len != len(mv):
            self.broken = True
            raise ProtocolError(
                f"response body is {hdr.pkg_len} bytes, expected {len(mv)}"
                + (f" ({context})" if context else ""))
        self.recv_exact_into(mv)

    def recv_response_stream(self, fh, context: str = "",
                             segment: int = 256 * 1024) -> int:
        """Stream a response body into file object ``fh`` in bounded
        recv_into segments — a multi-GB download holds O(segment) client
        memory, the mirror of send_request's iterable-body path.
        Returns the body length."""
        hdr = self.recv_header()
        if hdr.status != 0:
            self._raise_status(hdr, context)
        remaining = hdr.pkg_len
        if remaining == 0:
            return 0
        buf = bytearray(min(segment, remaining))
        mv = memoryview(buf)
        while remaining > 0:
            want = min(len(buf), remaining)
            try:
                k = self.sock.recv_into(mv[:want], want)
            except OSError:
                self.broken = True
                raise
            if k == 0:
                self.broken = True
                raise ProtocolError("connection closed mid-message")
            try:
                fh.write(mv[:k])
            except BaseException:
                # The SINK failing (ENOSPC, closed file) leaves body
                # bytes unread — the stream cannot be resynced, so the
                # pool must never reuse this connection (the mirror of
                # send_request's any-failure guard on the source side).
                self.broken = True
                raise
            remaining -= k
        return hdr.pkg_len


class ConnectionPool:
    """Endpoint-keyed pool of idle connections with borrow-time health
    checks (reference: libfastcommon connection_pool.c,
    ``g_use_connection_pool``).

    A request/response protocol leaves a healthy connection quiet between
    operations, so an idle socket that polls readable has either been
    closed by the peer (EOF) or desynced (stray bytes) — both discard.
    Connections marked ``broken`` by mid-message failures are never
    pooled.  Thread-safe; callers acquire/release around each operation.

    Dead-peer backoff: after a transport failure the caller reports the
    endpoint via ``mark_dead``; for ``dead_peer_cooldown`` seconds
    ``is_dead`` answers True so routing layers can deprioritize the
    endpoint instead of paying a connect timeout per operation.  The
    mark is advisory — callers with no alternative still connect, and a
    successful fresh connect clears it early.

    Multiplexing: the pool tracks in-use connections per
    endpoint; ``max_conns_per_endpoint`` caps idle + in-use together
    (0 = unbounded).  At the cap, ``acquire`` waits up to
    ``cap_wait_seconds`` for a release before connecting over the cap
    anyway (recorded in ``cap_overflows``) — a soft bound, so a leaked
    borrow degrades to the uncapped behavior instead of deadlocking a
    download.

    Hygiene: a time-gated ``sweep`` — run from ``release``
    and ``acquire``, or called directly — closes idle connections past
    ``max_idle_seconds`` and drops expired ``_dead`` marks even for
    endpoints no caller ever touches again (peers that left the
    cluster), and ``max_idle_total`` caps the pool-wide parked count by
    evicting the oldest idle connection across all endpoints.
    """

    def __init__(self, max_idle_per_endpoint: int = 8,
                 max_idle_seconds: float = 300.0,
                 dead_peer_cooldown: float = 30.0,
                 max_conns_per_endpoint: int = 0,
                 max_idle_total: int = 64,
                 cap_wait_seconds: float = 5.0,
                 sweep_interval: float = 5.0):
        self.max_idle_per_endpoint = max_idle_per_endpoint
        self.max_idle_seconds = max_idle_seconds
        self.dead_peer_cooldown = dead_peer_cooldown
        self.max_conns_per_endpoint = max_conns_per_endpoint
        self.max_idle_total = max_idle_total
        self.cap_wait_seconds = cap_wait_seconds
        self.sweep_interval = sweep_interval
        self._idle: dict[tuple[str, int], deque] = {}
        self._dead: dict[tuple[str, int], float] = {}
        self._in_use: dict[tuple[str, int], int] = {}
        self._lock = threading.Lock()
        self._released = threading.Condition(self._lock)
        self._last_sweep = time.monotonic()
        self.hits = 0
        self.misses = 0
        self.cap_overflows = 0
        self.swept_idle = 0

    def acquire(self, host: str, port: int,
                timeout: float = 30.0) -> Connection:
        self._maybe_sweep()
        key = (host, port)
        deadline = None
        while True:
            now = time.monotonic()
            with self._lock:
                q = self._idle.get(key)
                entry = q.popleft() if q else None
                if entry is not None:
                    self._in_use[key] = self._in_use.get(key, 0) + 1
                elif (self.max_conns_per_endpoint > 0 and
                      self._in_use.get(key, 0) >=
                      self.max_conns_per_endpoint):
                    # At the cap with nothing parked: wait for a release
                    # (bounded), then overflow rather than deadlock.
                    if deadline is None:
                        deadline = now + max(0.0, self.cap_wait_seconds)
                    remaining = deadline - time.monotonic()
                    if remaining > 0:
                        self._released.wait(remaining)
                        continue
                    self.cap_overflows += 1
                    self._in_use[key] = self._in_use.get(key, 0) + 1
                else:
                    self._in_use[key] = self._in_use.get(key, 0) + 1
            if entry is None:
                break
            conn, parked_at = entry
            if now - parked_at > self.max_idle_seconds or not _quiet(conn):
                conn.close()
                with self._lock:
                    # The dead parked conn is not a borrow; retry the
                    # idle queue without double-counting.
                    self._dec_in_use(key)
                continue
            with self._lock:
                self.hits += 1
            return conn
        with self._lock:
            self.misses += 1
        try:
            conn = Connection(host, port, timeout)
        except OSError:
            with self._lock:
                self._dec_in_use(key)
            raise
        # A fresh connect succeeding is live proof: clear any cooldown
        # early rather than waiting out the timer.
        with self._lock:
            self._dead.pop(key, None)
        return conn

    def _dec_in_use(self, key: tuple[str, int]) -> None:
        # _lock held.  Floor at zero: a double release (or a release of
        # a connection acquired before a pool reconfigure) must never
        # wedge the cap accounting negative.
        n = self._in_use.get(key, 0) - 1
        if n > 0:
            self._in_use[key] = n
        else:
            self._in_use.pop(key, None)
        self._released.notify()

    def in_use_count(self, host: str | None = None,
                     port: int | None = None) -> int:
        """Borrowed (not yet released) connections — one endpoint when
        given, pool-wide otherwise."""
        with self._lock:
            if host is not None:
                return self._in_use.get((host, port), 0)
            return sum(self._in_use.values())

    # -- dead-peer backoff -------------------------------------------------

    def mark_dead(self, host: str, port: int) -> None:
        """Start (or extend) the cooldown for one endpoint after a
        transport failure.  No-op when the cooldown is disabled (<= 0)."""
        if self.dead_peer_cooldown <= 0:
            return
        with self._lock:
            self._dead[(host, port)] = (time.monotonic()
                                        + self.dead_peer_cooldown)

    def is_dead(self, host: str, port: int) -> bool:
        """True while the endpoint is inside its failure cooldown.
        Expired marks are dropped on read, so a peer that stays quiet
        past the cooldown costs nothing."""
        with self._lock:
            deadline = self._dead.get((host, port))
            if deadline is None:
                return False
            if time.monotonic() >= deadline:
                del self._dead[(host, port)]
                return False
            return True

    def release(self, conn: Connection) -> None:
        conn.trace_ctx = None  # a parked conn must not carry a stale trace
        conn.priority = None   # ...nor a stale QoS class
        key = (conn.host, conn.port)
        if conn.broken:
            conn.close()
            with self._lock:
                self._dec_in_use(key)
            self._maybe_sweep()
            return
        to_close = []
        with self._lock:
            self._dec_in_use(key)
            q = self._idle.setdefault(key, deque())
            if any(c is conn for c, _ in q):
                # Double release: parking the same connection twice
                # would hand one socket to two future borrowers.  The
                # deque is bounded (max_idle_per_endpoint), so the scan
                # is O(8).
                return
            if len(q) >= self.max_idle_per_endpoint:
                to_close.append(q.popleft()[0])
            q.append((conn, time.monotonic()))
            # Pool-wide idle cap: evict the globally oldest parked conn
            # so one hot endpoint cannot strand dozens of sockets on
            # endpoints that went quiet.
            while (self.max_idle_total > 0 and
                   sum(len(d) for d in self._idle.values()) >
                   self.max_idle_total):
                oldest_key = min(
                    (k for k, d in self._idle.items() if d),
                    key=lambda k: self._idle[k][0][1])
                to_close.append(self._idle[oldest_key].popleft()[0])
                if not self._idle[oldest_key]:
                    del self._idle[oldest_key]
        for old in to_close:
            old.close()
        self._maybe_sweep()

    # -- hygiene ------------------------------------------------

    def _maybe_sweep(self) -> None:
        with self._lock:
            due = (time.monotonic() - self._last_sweep
                   >= self.sweep_interval)
        if due:
            self.sweep()

    def sweep(self, now: float | None = None) -> None:
        """Close idle connections past their TTL and drop expired
        ``_dead`` marks — including for endpoints that left the cluster
        and will never be acquired again (the leak this fixes: TTLs
        were previously only checked at acquire time)."""
        if now is None:
            now = time.monotonic()
        to_close = []
        with self._lock:
            self._last_sweep = now
            for key in list(self._idle):
                q = self._idle[key]
                while q and now - q[0][1] > self.max_idle_seconds:
                    to_close.append(q.popleft()[0])
                if not q:
                    del self._idle[key]
            for key in list(self._dead):
                if now >= self._dead[key]:
                    del self._dead[key]
            self.swept_idle += len(to_close)
        for conn in to_close:
            conn.close()

    def purge(self, host: str, port: int) -> None:
        """Drop every idle connection to one endpoint (called after an
        operation on a pooled connection fails: a silently-dead peer
        passes the borrow-time check, so its siblings are suspect)."""
        with self._lock:
            q = self._idle.pop((host, port), None)
        for conn, _ in (q or ()):
            conn.close()

    def close_all(self) -> None:
        with self._lock:
            queues = list(self._idle.values())
            self._idle.clear()
        for q in queues:
            for conn, _ in q:
                conn.close()

    def idle_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._idle.values())

    def dead_mark_count(self) -> int:
        """Endpoints currently carrying a dead-peer cooldown mark
        (expired marks linger until a read or a sweep drops them)."""
        with self._lock:
            return len(self._dead)


def _quiet(conn: Connection) -> bool:
    """True when the idle socket shows no pending data/EOF (reusable)."""
    try:
        readable, _, _ = select.select([conn.sock], [], [], 0)
        return not readable
    except (OSError, ValueError):
        return False
