"""High-level client: the two-hop tracker->storage dance.

The port's copy of ``fastdfs_tpu/client/client.py``: ``FdfsClient`` reads
client.conf (the tracker_server list), queries a tracker for a storage
target for every operation and talks to that storage directly, with the
reference's failover, placement and hot routing, admission retries,
parallel ranged downloads and fallback counters.  One argument is new:
``device``, where dedup uploads fingerprint (``cuda`` unless the caller
passes ``cpu``).  It is resolved once in the constructor and passed to
every ``StorageClient`` the client opens.
"""

from __future__ import annotations

import concurrent.futures
import os
import random
import time
from collections import OrderedDict

import torch

from fastdfs_tpu_torch.client.conn import (ConnectionPool, ProtocolError,
                                          StatusError)
from fastdfs_tpu_torch.client.fingerprint import fingerprint_buffer
from fastdfs_tpu_torch.client.storage_client import (RemoteFileInfo,
                                                    StorageClient)
from fastdfs_tpu_torch.client.tracker_client import (FetchTarget,
                                                    StoreTarget,
                                                    TrackerClient)
from fastdfs_tpu_torch.common.ini_config import IniConfig
from fastdfs_tpu_torch.common.jumphash import (jump_hash, placement_key,
                                               replica_for_range)
from fastdfs_tpu_torch.ops import resolve_device


class FdfsClient:
    """Tracker-routed client (reference: storage_upload_by_filename1 flow
    in SURVEY.md §3.1)."""

    def __init__(self, tracker_addrs: list[str] | str, timeout: float = 30.0,
                 use_pool: bool = True, dedup_uploads: bool = False,
                 dedup_min_bytes: int = 64 * 1024,
                 dedup_min_ratio: float = 0.05,
                 dedup_digest_cache: int = 1 << 16,
                 parallel_downloads: int = 1,
                 download_range_bytes: int = 4 << 20,
                 use_placement: bool = False,
                 dead_peer_cooldown_s: float = 30.0,
                 max_conns_per_endpoint: int = 0,
                 pool_idle_ttl_s: float = 300.0,
                 priority: int | None = None,
                 admission_retries: int = 2,
                 hot_routing: bool = True,
                 hot_map_ttl_s: float = 5.0,
                 device: str | torch.device = "cuda"):
        # Where dedup uploads fingerprint (fingerprint_buffer); resolved
        # first, so a missing card raises before anything else is set up.
        self.device = resolve_device(device)
        if isinstance(tracker_addrs, str):
            tracker_addrs = [tracker_addrs]
        if not tracker_addrs:
            raise ValueError("need at least one tracker address")
        self.trackers = [_parse_addr(a) for a in tracker_addrs]
        self.timeout = timeout
        # Pooled, health-checked connections per endpoint (reference:
        # connection_pool.c / client.conf:use_connection_pool); every
        # operation borrows and parks instead of reconnecting twice.
        # The pool also keeps the dead-peer cooldown map: endpoints that
        # failed at the transport level are deprioritized for
        # dead_peer_cooldown_s so each operation does not re-pay a
        # connect timeout against the same silent peer.
        # Multiplexing: max_conns_per_endpoint bounds idle +
        # in-use per (host, port) — concurrent borrowers (parallel
        # ranged downloads, threaded callers) grow the pool under load
        # up to the cap instead of serializing through one socket —
        # and pool_idle_ttl_s ages parked sockets out even for
        # endpoints that left the cluster.
        self.pool = (ConnectionPool(dead_peer_cooldown=dead_peer_cooldown_s,
                                    max_conns_per_endpoint=int(
                                        max_conns_per_endpoint),
                                    max_idle_seconds=float(pool_idle_ttl_s))
                     if use_pool else None)
        # Distributed tracing: a fastdfs_tpu_torch.trace.Tracer (or None).
        # While set, every tracker/storage connection this client
        # acquires carries the tracer's current wire context, so daemon
        # spans stitch under the client's open span (trace.traced_upload
        # installs one around a single operation).
        self.tracer = None
        # Request QoS: when set (a protocol.PriorityClass
        # int, 0 control .. 4 background), every tracker/storage request
        # this client sends carries a PRIORITY prefix frame so the
        # daemons' admission ladders shed by the caller's declared class
        # instead of the opcode default.  admission_retries bounds how
        # many times an operation shed with a retry-after hint is
        # retried (after honoring the jittered hint) before the EBUSY
        # propagates.
        self.priority = priority
        self.admission_retries = max(int(admission_retries), 0)
        # Dedup-aware negotiated uploads (opt-in): when enabled,
        # upload_buffer routes through upload_buffer_dedup.  The
        # negotiation costs one extra round-trip, so small payloads
        # (< dedup_min_bytes) and payloads whose ESTIMATED dup ratio —
        # the fraction of chunk digests this client has uploaded
        # recently (bounded LRU) — falls below dedup_min_ratio go
        # straight to the classic single-RTT UPLOAD_FILE instead.
        self.dedup_uploads = dedup_uploads
        self.dedup_min_bytes = dedup_min_bytes
        self.dedup_min_ratio = dedup_min_ratio
        self._dedup_digest_cache = dedup_digest_cache
        self._seen_digests: OrderedDict[bytes, None] = OrderedDict()
        # Parallel ranged downloads (opt-in): with parallel_downloads > 1
        # every read over ~one range splits into download_range_bytes
        # ranges fetched concurrently, each from the replica jump-hash
        # picks for (file id, range index) — consistent across clients,
        # so per-replica read caches accumulate hits.  Falls back to the
        # classic single-stream download transparently on any failure.
        self.parallel_downloads = max(int(parallel_downloads), 1)
        self.download_range_bytes = max(int(download_range_bytes), 64 * 1024)
        # Placement routing (opt-in, store_lookup = 3 clusters): keyed
        # uploads route straight to a storage of the jump-hash home group
        # computed over a cached placement epoch (QUERY_PLACEMENT) — no
        # per-upload tracker round-trip.  Any refusal (the epoch drifted:
        # a group started draining and answers EBUSY, a member moved)
        # drops the cache and falls back to the classic tracker hop,
        # which always carries the key so the TRACKER applies the same
        # hash — routing stays correct, only the shortcut is lost.
        self.use_placement = bool(use_placement)
        self._placement: dict | None = None
        self._placement_rr = 0
        # Client-side resilience accounting (stats()): lifetime counts
        # of every transparent fallback this client took.  The paths are
        # silent by design — correctness never depended on the fast
        # path — so without these an operator cannot tell "dedup is
        # winning" from "dedup quietly gave up on every upload".
        self._fallbacks = {"dedup_fallback_plain": 0,
                           "placement_fallback_tracker": 0,
                           "ranged_fallback_single": 0,
                           "dead_peer_skips": 0,
                           "admission_retry_waits": 0,
                           "hot_route_reads": 0,
                           "hot_fallback_reads": 0}
        # Elastic hot replication: reads consult a cached
        # QUERY_HOT_MAP snapshot (TTL'd, delta-refreshed) and spread a
        # hot file's downloads across home + extra replica groups with
        # the same stateless jump-hash every client agrees on.  The map
        # is advisory: any miss, stale route, or tracker too old to
        # answer falls back to the classic tracker-routed read.
        self.hot_routing = bool(hot_routing)
        self.hot_map_ttl_s = max(float(hot_map_ttl_s), 0.5)
        self._hot_state: dict | None = None
        self._hot_rr = 0

    @classmethod
    def from_conf(cls, conf_path: str,
                  device: str | torch.device = "cuda") -> "FdfsClient":
        cfg = IniConfig.load(conf_path)
        addrs = cfg.get_all("tracker_server")
        return cls(addrs, timeout=float(cfg.get_seconds("network_timeout", 30)),
                   use_pool=bool(cfg.get_bool("use_connection_pool", True)),
                   dedup_uploads=bool(cfg.get_bool("dedup_uploads", False)),
                   dedup_min_bytes=int(cfg.get_bytes("dedup_min_bytes",
                                                     64 * 1024)),
                   dedup_min_ratio=float(cfg.get("dedup_min_ratio", 0.05)),
                   parallel_downloads=int(cfg.get("parallel_downloads", 1)),
                   download_range_bytes=int(
                       cfg.get_bytes("download_range_bytes", 4 << 20)),
                   use_placement=bool(cfg.get_bool("use_placement", False)),
                   dead_peer_cooldown_s=float(
                       cfg.get_seconds("dead_peer_cooldown_s", 30)),
                   max_conns_per_endpoint=int(
                       cfg.get("max_conns_per_endpoint", 0)),
                   pool_idle_ttl_s=float(
                       cfg.get_seconds("pool_idle_ttl_s", 300)),
                   priority=(int(cfg.get("request_priority", -1))
                             if int(cfg.get("request_priority", -1)) >= 0
                             else None),
                   admission_retries=int(cfg.get("admission_retries", 2)),
                   hot_routing=bool(cfg.get_bool("hot_routing", True)),
                   hot_map_ttl_s=float(cfg.get_seconds("hot_map_ttl_s", 5)),
                   device=device)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close_all()

    def stats(self) -> dict:
        """Lifetime client-side fallback counters: how often the dedup
        upload fell back to a plain UPLOAD_FILE, the placement shortcut
        fell back to the tracker hop, a parallel ranged download fell
        back to the classic single stream, and routing skipped a peer
        inside its dead-peer cooldown in favor of a live one.  The
        fallbacks are transparent (the call still succeeds), so this is
        the only place their frequency is visible.  ``hot_route_reads``
        counts downloads served by an elastic hot replica
        and ``hot_fallback_reads`` the routed attempts that fell back
        to the classic tracker hop (stale map after a demotion, dead
        member)."""
        return dict(self._fallbacks)

    def _wire_ctx(self):
        return self.tracer.wire_ctx() if self.tracer is not None else None

    def _admission_wait(self, e: StatusError) -> None:
        """Honor an admission shed's retry-after hint: sleep the hinted
        interval plus up to 25% jitter, so a fleet of clients shed in
        the same tick does not stampede back in lockstep.  EBUSY
        WITHOUT a hint (max_connections refusal, non-leader, drain)
        never sleeps — those are answered by a different endpoint, not
        by waiting."""
        if e.retry_after_ms > 0:
            self._fallbacks["admission_retry_waits"] += 1
            time.sleep((e.retry_after_ms / 1000.0)
                       * (1.0 + 0.25 * random.random()))

    def _shed_retry(self, fn):
        """Run ``fn()``; when the admission ladder sheds it (StatusError
        EBUSY carrying a retry-after hint) sleep the jittered hint and
        re-run the WHOLE operation — including the tracker hop, which
        may well route the retry to a less-loaded peer — up to
        admission_retries times before the EBUSY propagates.  A shed
        happens at request-header stage, before any response body
        moves, so every operation here is safe to re-issue."""
        for _ in range(self.admission_retries):
            try:
                return fn()
            except StatusError as e:
                if e.status != 16 or e.retry_after_ms <= 0:
                    raise
                self._admission_wait(e)
        return fn()

    def _routed(self, query, op):
        """The classic two-hop dance (tracker query -> storage op) with
        admission-shed retry wrapped around the whole pair."""
        def run():
            tgt = self._with_tracker(query)
            with self._storage(tgt) as s:
                return op(s)
        return self._shed_retry(run)

    def _tracker(self) -> TrackerClient:
        # Random start + failover (reference: tracker_get_connection's
        # round-robin over the tracker group).  Trackers inside their
        # dead-peer cooldown sort last: they are still tried — the mark
        # is advisory, and with every tracker dead the order is simply
        # unchanged — but a live sibling wins without paying a connect
        # timeout first.
        addrs = self.trackers[:]
        random.shuffle(addrs)
        if self.pool is not None and len(addrs) > 1:
            dead = [a for a in addrs if self.pool.is_dead(*a)]
            if dead and len(dead) < len(addrs):
                addrs = [a for a in addrs if a not in dead] + dead
                self._fallbacks["dead_peer_skips"] += len(dead)
        last_err: Exception | None = None
        for host, port in addrs:
            try:
                if self.pool is not None:
                    conn = self.pool.acquire(host, port, self.timeout)
                    conn.trace_ctx = self._wire_ctx()
                    conn.priority = self.priority
                    return TrackerClient(host, port, self.timeout,
                                         conn=conn, release=self.pool.release)
                t = TrackerClient(host, port, self.timeout)
                t.conn.trace_ctx = self._wire_ctx()
                t.conn.priority = self.priority
                return t
            except OSError as e:
                last_err = e
                if self.pool is not None:
                    self.pool.mark_dead(host, port)
        raise ConnectionError(f"no tracker reachable: {last_err}")

    def _with_tracker(self, fn):
        """Run ``fn(tracker_client)``; a pooled connection to a
        silently-dead tracker passes the borrow check and fails only
        inside the operation, so on transport failure purge that
        endpoint's idle set and fail over (up to one pass per tracker —
        the pre-pool behavior, where connect-time errors drove the
        failover loop)."""
        attempts = max(len(self.trackers), 1) + 1
        last: Exception | None = None
        for _ in range(attempts):
            t = self._tracker()
            endpoint = (t.conn.host, t.conn.port)
            try:
                with t:
                    return fn(t)
            except StatusError as e:
                # A non-zero application status (e.g. ENOENT) is a
                # deterministic answer, not a transport failure: purging
                # the pool and retrying every tracker would just repeat
                # it.  EBUSY (16) is the exception — endpoint-specific
                # load (max_connections refusal, non-leader) that another
                # tracker may well answer; retry WITHOUT purging (the
                # transport is fine).  Crucially it must NOT mark the
                # endpoint dead either — an admission shed means "alive
                # but shedding", and a dead-mark would steer the next
                # dead_peer_cooldown_s of traffic away from a healthy
                # tracker.  A shed's retry-after hint is honored
                # (jittered) before the next attempt.
                if e.status != 16:
                    raise
                last = e
                self._admission_wait(e)
            except (OSError, ProtocolError) as e:
                last = e
                if self.pool is not None:
                    self.pool.purge(*endpoint)
                    self.pool.mark_dead(*endpoint)
        raise last if last is not None else ConnectionError("no tracker")

    def _storage(self, tgt) -> StorageClient:
        if self.pool is not None:
            conn = self.pool.acquire(tgt.ip, tgt.port, self.timeout)
            conn.trace_ctx = self._wire_ctx()
            conn.priority = self.priority
            return StorageClient(tgt.ip, tgt.port, self.timeout,
                                 conn=conn, release=self.pool.release,
                                 device=self.device)
        s = StorageClient(tgt.ip, tgt.port, self.timeout, device=self.device)
        s.conn.trace_ctx = self._wire_ctx()
        s.conn.priority = self.priority
        return s

    # -- operations --------------------------------------------------------

    def upload_buffer(self, data: bytes, ext: str = "",
                      group: str | None = None, appender: bool = False,
                      key: str | None = None) -> str:
        """``key``: optional placement key (store_lookup = 3 clusters).
        The tracker — or this client directly, with ``use_placement`` —
        jump-hashes it over the placement epoch so the same key always
        homes in the same group; other cluster policies ignore it."""
        if self.dedup_uploads and not appender:
            return self.upload_buffer_dedup(data, ext=ext, group=group,
                                            key=key)
        return self._upload_buffer_plain(data, ext=ext, group=group,
                                         appender=appender, key=key)

    def _placement_route(self, key: str) -> StoreTarget | None:
        """Storage target for ``key`` from the cached placement epoch —
        or None when no epoch is available (tracker too old, no active
        group), which means: take the classic tracker hop."""
        table = self._placement
        if table is None:
            try:
                table = self._with_tracker(lambda t: t.query_placement())
            except (StatusError, ProtocolError, ConnectionError, OSError):
                return None
            self._placement = table
        active = [g for g in table["groups"]
                  if g["state"] == 0 and g["members"]]
        if not active:
            return None
        g = active[jump_hash(placement_key(key), len(active))]
        self._placement_rr += 1
        members = g["members"]
        idx = self._placement_rr % len(members)
        if (self.pool is not None
                and self.pool.is_dead(members[idx]["ip"],
                                      members[idx]["port"])):
            # Round-robin landed on a member inside its dead-peer
            # cooldown: advance to the next live one (all-dead keeps the
            # pick — the upload path's own fallback covers the failure).
            live = [i for i in range(len(members))
                    if not self.pool.is_dead(members[i]["ip"],
                                             members[i]["port"])]
            if live:
                idx = live[self._placement_rr % len(live)]
                self._fallbacks["dead_peer_skips"] += 1
        m = members[idx]
        return StoreTarget(group=g["group"], ip=m["ip"], port=m["port"],
                           store_path_index=0xFF)

    def _upload_buffer_plain(self, data: bytes, ext: str = "",
                             group: str | None = None,
                             appender: bool = False,
                             key: str | None = None) -> str:
        # The classic single-RTT path; also every dedup fallback's target
        # (it must never re-enter the dedup gate, or a fallback recurses).
        if key is not None and group is None and self.use_placement:
            tgt = self._placement_route(key)
            if tgt is not None:
                try:
                    with self._storage(tgt) as s:
                        return s.upload_buffer(
                            data, ext=ext,
                            store_path_index=tgt.store_path_index,
                            appender=appender)
                except (StatusError, ProtocolError, OSError):
                    # Epoch drift (EBUSY from a now-draining group) or a
                    # dead member: forget the cache, fall through to the
                    # tracker, which re-hashes the key itself.
                    self._placement = None
                    self._fallbacks["placement_fallback_tracker"] += 1

        def run():
            tgt = self._with_tracker(
                lambda t: t.query_store(group, key=key))
            with self._storage(tgt) as s:
                return s.upload_buffer(data, ext=ext,
                                       store_path_index=tgt.store_path_index,
                                       appender=appender)
        return self._shed_retry(run)

    def _remember_digests(self, chunks) -> None:
        cache = self._seen_digests
        for _, digest in chunks:
            cache[digest] = None
            cache.move_to_end(digest)
        while len(cache) > self._dedup_digest_cache:
            cache.popitem(last=False)

    def upload_buffer_dedup(self, data: bytes, ext: str = "",
                            group: str | None = None,
                            min_dup_ratio: float | None = None,
                            stats: dict | None = None,
                            key: str | None = None) -> str:
        """Dedup-aware negotiated upload (UPLOAD_RECIPE/UPLOAD_CHUNKS):
        fingerprint locally, then ship only chunks the storage daemon's
        content-addressed store lacks — a warm re-upload moves ~0 data
        bytes.  Falls back to a plain UPLOAD_FILE transparently when:

        - the payload is small (< dedup_min_bytes — below the daemon's
          chunking threshold the recipe cannot be stored anyway);
        - the estimated dup ratio (recently-uploaded-digest LRU hit
          fraction) is under ``min_dup_ratio`` — fresh content would pay
          the extra round-trip for nothing (pass 0 to always negotiate);
        - the daemon lacks the opcodes or a chunk store, or the session
          fails mid-flight (StorageClient-level fallback).
        """
        if stats is None:
            stats = {}
        ratio_floor = (self.dedup_min_ratio if min_dup_ratio is None
                       else min_dup_ratio)
        if len(data) < self.dedup_min_bytes:
            stats.update(fallback="small", bytes_sent=len(data))
            self._fallbacks["dedup_fallback_plain"] += 1
            return self._upload_buffer_plain(data, ext=ext, group=group,
                                             key=key)
        chunks = [(fp.length, fp.digest)
                  for fp in fingerprint_buffer(data, device=self.device)]
        if ratio_floor > 0:
            hits = sum(1 for _, d in chunks if d in self._seen_digests)
            estimate = hits / len(chunks) if chunks else 0.0
            stats["estimated_dup_ratio"] = estimate
            if estimate < ratio_floor:
                self._remember_digests(chunks)
                stats.update(fallback="low_estimate", bytes_sent=len(data))
                self._fallbacks["dedup_fallback_plain"] += 1
                return self._upload_buffer_plain(data, ext=ext, group=group,
                                                 key=key)
        self._remember_digests(chunks)
        tgt = self._with_tracker(lambda t: t.query_store(group, key=key))
        with self._storage(tgt) as s:
            fid = s.upload_buffer_dedup(
                data, ext=ext, store_path_index=tgt.store_path_index,
                chunks=chunks, stats=stats)
        # StorageClient-level bail-outs (daemon lacks the opcodes / a
        # chunk store, mid-session failure) report through the same
        # stats dict — one counter covers every dedup→plain path.
        if stats.get("fallback"):
            self._fallbacks["dedup_fallback_plain"] += 1
        return fid

    def download_to_buffer(self, file_id: str, offset: int = 0,
                           length: int = 0) -> bytes:
        if self.parallel_downloads > 1:
            return self.download_ranged(file_id, offset, length)
        return self._download_single(file_id, offset, length)

    def _download_single(self, file_id: str, offset: int = 0,
                         length: int = 0) -> bytes:
        # The classic one-connection path; also the ranged download's
        # transparent fallback target (it must never re-enter the
        # parallel gate, or a fallback recurses).  Hot routing rides in
        # front: when the cached hot map lists extra replica groups for
        # this file and the spread hash picks one, the read goes there
        # directly; None (not hot, home pick, or any failure) falls
        # through to the tracker hop.
        if self.hot_routing:
            data = self._hot_download(file_id, offset, length)
            if data is not None:
                return data
        return self._routed(lambda t: t.query_fetch(file_id),
                            lambda s: s.download_to_buffer(file_id, offset,
                                                           length))

    def _hot_groups(self, file_id: str) -> list[str] | None:
        """Extra replica groups for ``file_id`` from the cached hot map,
        refreshing it at most once per ``hot_map_ttl_s`` (delta query
        carrying the cached version; a tombstone delta entry — zero
        groups — evicts a demoted key).  Every refresh failure keeps the
        stale map and waits for the next TTL window: the map is
        advisory, never load-bearing."""
        now = time.monotonic()
        st = self._hot_state
        if st is None:
            st = {"version": -1, "entries": {}, "fetched": float("-inf")}
            self._hot_state = st
        if now - st["fetched"] >= self.hot_map_ttl_s:
            st["fetched"] = now  # one attempt per window, pass or fail
            try:
                since = st["version"] if st["version"] >= 0 else None
                resp = self._with_tracker(lambda t: t.query_hot_map(since))
                if resp["full"]:
                    st["entries"] = {e["key"]: e["groups"]
                                     for e in resp["entries"] if e["groups"]}
                else:
                    for e in resp["entries"]:
                        if e["groups"]:
                            st["entries"][e["key"]] = e["groups"]
                        else:
                            st["entries"].pop(e["key"], None)
                st["version"] = resp["version"]
            except Exception:  # noqa: BLE001 — advisory map, incl. old
                # trackers (unknown command) and monkeypatched mocks;
                # back off harder on a protocol-level refusal so a
                # pre-hot-map tracker is not re-asked every window.
                st["fetched"] = now + 11 * self.hot_map_ttl_s
        return st["entries"].get(file_id)

    def _hot_member(self, group: str) -> StoreTarget | None:
        """An ACTIVE member of ``group`` from the cached placement epoch
        (round-robin across members, dead peers skipped) — or None when
        the group is unknown/empty, meaning: no hot shortcut."""
        table = self._placement
        if table is None:
            try:
                table = self._with_tracker(lambda t: t.query_placement())
            except Exception:  # noqa: BLE001 — shortcut only
                return None
            if not isinstance(table, dict) or "groups" not in table:
                return None  # monkeypatched tracker hop: no shortcut
            self._placement = table
        for g in table["groups"]:
            if g["group"] != group or g["state"] != 0 or not g["members"]:
                continue
            members = g["members"]
            self._placement_rr += 1
            idx = self._placement_rr % len(members)
            if (self.pool is not None
                    and self.pool.is_dead(members[idx]["ip"],
                                          members[idx]["port"])):
                live = [i for i in range(len(members))
                        if not self.pool.is_dead(members[i]["ip"],
                                                 members[i]["port"])]
                if live:
                    idx = live[self._placement_rr % len(live)]
                    self._fallbacks["dead_peer_skips"] += 1
            m = members[idx]
            return StoreTarget(group=group, ip=m["ip"], port=m["port"],
                               store_path_index=0xFF)
        return None

    def _hot_download(self, file_id: str, offset: int,
                      length: int) -> bytes | None:
        """One hot-routed read attempt; None means 'take the classic
        path' (not hot, the spread hash picked the home group, no
        placement info, or the routed attempt failed — stale map after
        a demotion, member down).  The replica set is home + the map's
        extra groups in map order, so every client spreads reads with
        the same ``jump_hash(sha1(file_id#i), n_replicas)`` choice and
        per-replica caches accumulate hits."""
        groups = self._hot_groups(file_id)
        if not groups or "/" not in file_id:
            return None
        home, remote = file_id.split("/", 1)
        replicas = [home] + [g for g in groups if g != home]
        if len(replicas) < 2:
            return None
        self._hot_rr += 1
        pick = replicas[replica_for_range(file_id, self._hot_rr,
                                          len(replicas))]
        if pick == home:
            return None  # the classic tracker hop serves home reads
        tgt = self._hot_member(pick)
        if tgt is None:
            return None
        try:
            with self._storage(tgt) as s:
                data = s.download_to_buffer(f"{pick}/{remote}", offset,
                                            length)
            self._fallbacks["hot_route_reads"] += 1
            return data
        except Exception:  # noqa: BLE001 — transparent fallback
            # A stale route (the copy was demoted and dropped after the
            # map was cached) or a dead member: evict the cached entry
            # so this file stops routing until the next refresh, and
            # let the classic path serve the read.
            st = self._hot_state
            if st is not None:
                st["entries"].pop(file_id, None)
            self._fallbacks["hot_fallback_reads"] += 1
            return None

    def download_stream(self, file_id: str, fh, offset: int = 0,
                        length: int = 0) -> int:
        """Stream (part of) a file into ``fh`` with O(segment) client
        memory (StorageClient.download_stream underneath).  Returns the
        byte count written.  Shed-retry is safe here: a shed answers
        the request header, so no body byte has reached ``fh`` yet."""
        return self._routed(lambda t: t.query_fetch(file_id),
                            lambda s: s.download_stream(file_id, fh, offset,
                                                        length))

    def download_to_file(self, file_id: str, local_path: str,
                         offset: int = 0, length: int = 0,
                         parallel: int | None = None) -> int:
        parallel = self.parallel_downloads if parallel is None else parallel
        if parallel > 1:
            # Ranged bytes land in memory first; the write-out still
            # goes via temp + rename so a failed local write (ENOSPC,
            # kill) can never truncate an existing file or leave a
            # silently-partial one.
            data = self.download_ranged(file_id, offset, length,
                                        parallel=parallel)
            tmp = f"{local_path}.part{os.getpid()}"
            try:
                with open(tmp, "wb") as fh:
                    fh.write(data)
                os.replace(tmp, local_path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            return len(data)
        # Single stream: StorageClient owns the temp-file + rename
        # discipline (one implementation of the no-partial-file rule).
        return self._routed(lambda t: t.query_fetch(file_id),
                            lambda s: s.download_to_file(file_id, local_path,
                                                         offset, length))

    def download_ranged(self, file_id: str, offset: int = 0,
                        length: int = 0, parallel: int | None = None,
                        range_bytes: int | None = None) -> bytes:
        """Parallel ranged download: split [offset, offset+length) into
        download_range_bytes ranges and fetch them concurrently across
        the group's read-safe replicas (tracker QUERY_FETCH_ALL), each
        range from the replica ``jump_hash(file id, range index)`` picks
        — the stateless consistent choice every client agrees on, so
        per-replica hot-chunk caches accumulate hits (cache affinity).
        Each worker lands its range directly in its slice of the shared
        output buffer (DOWNLOAD_FILE's offset+count head fields carry
        the range; every daemon generation serves them).  ANY failure —
        an unreachable replica, a short/oversized body, a tracker too
        old to list replicas — falls back transparently to the classic
        single-stream download."""
        parallel = self.parallel_downloads if parallel is None else parallel
        range_bytes = (self.download_range_bytes if range_bytes is None
                       else range_bytes)
        if parallel <= 1:
            return self._download_single(file_id, offset, length)
        try:
            replicas = self._with_tracker(
                lambda t: t.query_fetch_all(file_id))
            if not replicas:
                raise ProtocolError("tracker listed no read replicas")
            with self._storage(replicas[replica_for_range(
                    file_id, 0, len(replicas))]) as s:
                size = s.query_file_info(file_id).file_size
            total = max(size - offset, 0)
            if length:
                total = min(total, length)
            if total <= range_bytes:  # one range: no split to win from
                return self._download_single(file_id, offset, length)
            ranges = []
            off = offset
            while off < offset + total:
                ln = min(range_bytes, offset + total - off)
                ranges.append((len(ranges), off, ln))
                off += ln
            buf = bytearray(total)
            mv = memoryview(buf)

            def fetch(idx: int, off: int, ln: int) -> None:
                # Cache-affinity pick first; a replica inside its
                # dead-peer cooldown yields to the next live one (the
                # affinity win is worthless against a connect timeout).
                # All-dead keeps the original pick — the mark is
                # advisory, and the outer fallback still covers failure.
                k = replica_for_range(file_id, idx, len(replicas))
                if (self.pool is not None
                        and self.pool.is_dead(replicas[k].ip,
                                              replicas[k].port)):
                    for step in range(1, len(replicas)):
                        alt = (k + step) % len(replicas)
                        if not self.pool.is_dead(replicas[alt].ip,
                                                 replicas[alt].port):
                            k = alt
                            self._fallbacks["dead_peer_skips"] += 1
                            break
                tgt = replicas[k]
                try:
                    with self._storage(tgt) as s:
                        s.download_into(file_id,
                                        mv[off - offset:off - offset + ln],
                                        offset=off)
                except OSError:
                    if self.pool is not None:
                        self.pool.mark_dead(tgt.ip, tgt.port)
                    raise

            with concurrent.futures.ThreadPoolExecutor(
                    min(parallel, len(ranges))) as ex:
                futs = [ex.submit(fetch, *r) for r in ranges]
                for f in futs:
                    f.result()  # re-raise the first failure
            return bytes(buf)
        except Exception:  # noqa: BLE001 — transparent whole-file fallback
            self._fallbacks["ranged_fallback_single"] += 1
            return self._download_single(file_id, offset, length)

    def delete_file(self, file_id: str) -> None:
        self._routed(lambda t: t.query_update(file_id),
                     lambda s: s.delete_file(file_id))

    def query_file_info(self, file_id: str) -> RemoteFileInfo:
        return self._routed(lambda t: t.query_fetch(file_id),
                            lambda s: s.query_file_info(file_id))

    def near_dups(self, file_id: str) -> list[tuple[str, float]]:
        """Ranked (file_id, score) near-duplicates of a stored file
        (dedup-engine MinHash index; fastdfs_tpu extension)."""
        tgt = self._with_tracker(lambda t: t.query_fetch(file_id))
        with self._storage(tgt) as s:
            return s.near_dups(file_id)

    def set_metadata(self, file_id: str, meta: dict[str, str],
                     merge: bool = False) -> None:
        self._routed(lambda t: t.query_update(file_id),
                     lambda s: s.set_metadata(file_id, meta, merge))

    def get_metadata(self, file_id: str) -> dict[str, str]:
        return self._routed(lambda t: t.query_fetch(file_id),
                            lambda s: s.get_metadata(file_id))

    def upload_appender_buffer(self, data: bytes, ext: str = "",
                               group: str | None = None) -> str:
        return self.upload_buffer(data, ext=ext, group=group, appender=True)

    def append_buffer(self, file_id: str, data: bytes) -> None:
        """Append to an appender file (routed to the source server, like
        every mutation — reference query_fetch_update update path)."""
        self._routed(lambda t: t.query_update(file_id),
                     lambda s: s.append_buffer(file_id, data))

    def modify_buffer(self, file_id: str, offset: int, data: bytes) -> None:
        self._routed(lambda t: t.query_update(file_id),
                     lambda s: s.modify_buffer(file_id, offset, data))

    def truncate_file(self, file_id: str, new_size: int = 0) -> None:
        self._routed(lambda t: t.query_update(file_id),
                     lambda s: s.truncate_file(file_id, new_size))

    def upload_slave_buffer(self, master_id: str, prefix: str, data: bytes,
                            ext: str = "") -> str:
        """Slave files live on the master's server (same name stem ⇒ same
        group and path), so route via query_update on the master."""
        tgt = self._with_tracker(lambda t: t.query_update(master_id))
        with self._storage(tgt) as s:
            return s.upload_slave_buffer(master_id, prefix, data, ext)

    def list_groups(self) -> list[dict]:
        return self._with_tracker(lambda t: t.list_groups())

    def delete_storage(self, group: str, ip: str, port: int) -> None:
        self._with_tracker(lambda t: t.delete_storage(group, ip, port))

    def set_trunk_server(self, group: str, ip: str, port: int) -> None:
        # The override must land on the tracker LEADER (followers refuse
        # with EBUSY=16 rather than proxying): ask any tracker who leads,
        # target it, and fall back to trying each tracker in turn.
        leader = self._with_tracker(lambda t: t.get_tracker_status().get("leader", ""))
        if leader:
            try:
                host, _, p = leader.rpartition(":")
                with TrackerClient(host, int(p), self.timeout) as t:
                    t.set_trunk_server(group, ip, port)
                    return
            except (OSError, StatusError):
                pass
        last: Exception | None = None
        for host, p in self.trackers:
            try:
                with TrackerClient(host, p, self.timeout) as t:
                    t.set_trunk_server(group, ip, port)
                    return
            except (OSError, StatusError) as e:
                last = e
        raise last if last else ConnectionError("no tracker accepted override")

    def tracker_status(self) -> dict:
        return self._with_tracker(lambda t: t.get_tracker_status())

    def list_storages(self, group: str) -> list[dict]:
        return self._with_tracker(lambda t: t.list_storages(group))

    def cluster_stat(self, group: str | None = None) -> dict:
        """Tracker-held cluster observability dump (role, groups,
        per-storage liveness + named beat stats)."""
        return self._with_tracker(lambda t: t.cluster_stat(group))

    def storage_stat(self, ip: str, port: int) -> dict:
        """One storage daemon's stats-registry snapshot (STAT opcode)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.stat()

    def storage_events(self, ip: str, port: int) -> dict:
        """One storage daemon's flight-recorder dump (EVENT_DUMP)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.event_dump()

    def storage_metrics_history(self, ip: str, port: int,
                                since_us: int = 0) -> dict:
        """One storage daemon's metrics-journal window (METRICS_HISTORY)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.metrics_history(since_us)

    def storage_heat_top(self, ip: str, port: int, k: int = 0) -> dict:
        """One storage daemon's hot-file top-K (HEAT_TOP)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.heat_top(k)

    def storage_profile_start(self, ip: str, port: int, hz: int = 97,
                              duration_s: int = 30) -> dict:
        """Arm one storage daemon's sampling profiler (PROFILE_CTL)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.profile_start(hz, duration_s)

    def storage_profile_stop(self, ip: str, port: int) -> dict:
        """Disarm one storage daemon's profiler early (idempotent)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.profile_stop()

    def storage_profile_dump(self, ip: str, port: int) -> dict:
        """One storage daemon's folded-stack dump (PROFILE_DUMP); shape
        per fastdfs_tpu.monitor.decode_profile."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.profile_dump()

    def health_matrix(self) -> dict:
        """The tracker's gray-failure differential matrix
        (HEALTH_MATRIX); shape per monitor.decode_health_matrix."""
        return self._with_tracker(lambda t: t.health_matrix())

    def storage_health_status(self, ip: str, port: int) -> dict:
        """One storage daemon's gray-failure health view (HEALTH_STATUS);
        shape per monitor.decode_health_status."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.health_status()

    def storage_admission_status(self, ip: str, port: int) -> dict:
        """One storage daemon's admission-ladder status
        (ADMISSION_STATUS); shape per monitor.decode_admission.  Born
        control-class server-side, so it answers even at reads-only."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.admission_status()

    def tracker_admission_status(self) -> dict:
        """The tracker's own admission-ladder status (ADMISSION_STATUS);
        shape per monitor.decode_admission."""
        return self._with_tracker(lambda t: t.admission_status())

    def scrub_status(self, ip: str, port: int) -> dict[str, int]:
        """One storage daemon's integrity-engine status (SCRUB_STATUS)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.scrub_status()

    def scrub_kick(self, ip: str, port: int) -> None:
        """Force a scrub pass on one storage daemon (SCRUB_KICK)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            s.scrub_kick()

    def ec_status(self, ip: str, port: int) -> dict[str, int]:
        """One storage daemon's erasure-coding status (EC_STATUS)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            return s.ec_status()

    def ec_kick(self, ip: str, port: int) -> None:
        """Force an EC demotion pass on one storage daemon (EC_KICK)."""
        with self._storage(FetchTarget(ip=ip, port=port)) as s:
            s.ec_kick()

    # -- placement epoch / group lifecycle ---------------------------------

    def _leader_call(self, fn):
        """Run ``fn(tracker_client)`` against the tracker LEADER
        (followers refuse leader-only admin ops with EBUSY=16 rather
        than proxying): ask any tracker who leads, target it, then fall
        back to trying each tracker in turn.  A deterministic refusal
        (unknown group, invalid transition) propagates immediately —
        another tracker would only repeat it."""
        leader = self._with_tracker(
            lambda t: t.get_tracker_status().get("leader", ""))
        if leader:
            host, _, p = leader.rpartition(":")
            try:
                with TrackerClient(host, int(p), self.timeout) as t:
                    return fn(t)
            except StatusError as e:
                if e.status != 16:
                    raise
            except OSError:
                pass
        last: Exception | None = None
        for host, p in self.trackers:
            try:
                with TrackerClient(host, p, self.timeout) as t:
                    return fn(t)
            except StatusError as e:
                if e.status != 16:
                    raise
                last = e
            except OSError as e:
                last = e
        raise last if last else ConnectionError("no tracker accepted the call")

    def query_placement(self) -> dict:
        """The placement epoch (group order + lifecycle states + active
        members), as any tracker serves it (QUERY_PLACEMENT)."""
        return self._with_tracker(lambda t: t.query_placement())

    def query_hot_map(self, since_version: int | None = None) -> dict:
        """The elastic hot-replication map (QUERY_HOT_MAP): published
        hot files and the extra groups serving each; ``since_version``
        asks for a delta (zero-group entries are tombstones)."""
        return self._with_tracker(lambda t: t.query_hot_map(since_version))

    def group_drain(self, group: str) -> int:
        """Start draining ``group`` (leader-routed GROUP_DRAIN).  Returns
        the new placement version."""
        return self._leader_call(lambda t: t.group_drain(group))

    def group_reactivate(self, group: str) -> int:
        """Cancel a drain (leader-routed GROUP_REACTIVATE).  Returns the
        new placement version."""
        return self._leader_call(lambda t: t.group_reactivate(group))


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad tracker address {addr!r} (want host:port)")
    return host, int(port)
