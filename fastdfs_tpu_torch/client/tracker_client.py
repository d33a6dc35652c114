"""Tracker client: cluster queries; the port's copy of
``fastdfs_tpu/client/tracker_client.py``.

Reference: ``client/tracker_client.c`` — tracker_query_storage_store(),
tracker_query_storage_fetch(), tracker_list_groups().  Hot-path queries are
fixed-width binary; list/monitor responses are JSON (this rebuild's
FastDFS-shaped protocol, served by ``native/tracker/``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from fastdfs_tpu_torch.client.conn import Connection, ProtocolError
from fastdfs_tpu_torch.common.protocol import (
    GROUP_NAME_MAX_LEN,
    IP_ADDRESS_SIZE,
    TrackerCmd,
    buff2long,
    long2buff,
    pack_group_name,
    pack_profile_ctl,
    unpack_group_name,
)


@dataclass(frozen=True)
class StoreTarget:
    group: str
    ip: str
    port: int
    store_path_index: int


@dataclass(frozen=True)
class FetchTarget:
    ip: str
    port: int


class TrackerClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 conn: Connection | None = None, release=None):
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

    # -- service queries (upload/download routing) -------------------------

    def query_store(self, group: str | None = None,
                    key: str | None = None) -> StoreTarget:
        """Which storage should take an upload (reference:
        tracker_query_storage_store).  Resp: 16B group + 16B ip + 8B port +
        1B store path index.  ``key`` (groupless form only) is the client's
        placement key — store_lookup = 3 trackers jump-hash it over the
        placement epoch; other policies ignore it."""
        if group is None:
            self.conn.send_request(
                TrackerCmd.SERVICE_QUERY_STORE_WITHOUT_GROUP_ONE,
                key.encode() if key else b"")
        else:
            self.conn.send_request(TrackerCmd.SERVICE_QUERY_STORE_WITH_GROUP_ONE,
                                   pack_group_name(group))
        body = self.conn.recv_response("query_store")
        if len(body) < GROUP_NAME_MAX_LEN + IP_ADDRESS_SIZE + 9:
            raise ProtocolError(f"short query_store response: {len(body)}")
        return StoreTarget(
            group=unpack_group_name(body[:16]),
            ip=body[16:32].rstrip(b"\x00").decode(),
            port=buff2long(body, 32),
            store_path_index=body[40],
        )

    def _query_fetch(self, cmd: int, file_id: str) -> FetchTarget:
        group, _, remote = file_id.partition("/")
        body = pack_group_name(group) + remote.encode()
        self.conn.send_request(cmd, body)
        resp = self.conn.recv_response("query_fetch")
        if len(resp) < IP_ADDRESS_SIZE + 8:
            raise ProtocolError(f"short query_fetch response: {len(resp)}")
        return FetchTarget(ip=resp[:16].rstrip(b"\x00").decode(),
                           port=buff2long(resp, 16))

    def query_fetch(self, file_id: str) -> FetchTarget:
        """Which replica can serve a read (sync-timestamp-safe routing)."""
        return self._query_fetch(TrackerCmd.SERVICE_QUERY_FETCH_ONE, file_id)

    def query_update(self, file_id: str) -> FetchTarget:
        """Which server takes mutations (metadata/delete) for this file."""
        return self._query_fetch(TrackerCmd.SERVICE_QUERY_UPDATE, file_id)

    def _parse_target_list(self, resp: bytes) -> tuple[str, int, list[FetchTarget]]:
        """ALL-variant reply: 16B group + 1B path idx + 8B count + count x
        (16B ip + 8B port)."""
        if len(resp) < GROUP_NAME_MAX_LEN + 9:
            raise ProtocolError(f"short target-list response: {len(resp)}")
        group = unpack_group_name(resp[:16])
        path_idx = resp[16]
        count = buff2long(resp, 17)
        rec = IP_ADDRESS_SIZE + 8
        if count < 0 or count > (len(resp) - 25) // rec:
            raise ProtocolError(f"bad target-list count {count}")
        targets = []
        for i in range(count):
            off = 25 + i * rec
            targets.append(FetchTarget(
                ip=resp[off:off + 16].rstrip(b"\x00").decode(),
                port=buff2long(resp, off + 16)))
        return group, path_idx, targets

    def query_store_all(self, group: str | None = None) \
            -> tuple[str, list[FetchTarget]]:
        """All writable storages of the picked group (reference:
        QUERY_STORE_WITHOUT_GROUP_ALL 106 / WITH_GROUP_ALL 107 — the client
        retries among them)."""
        if group is None:
            self.conn.send_request(
                TrackerCmd.SERVICE_QUERY_STORE_WITHOUT_GROUP_ALL)
        else:
            self.conn.send_request(
                TrackerCmd.SERVICE_QUERY_STORE_WITH_GROUP_ALL,
                pack_group_name(group))
        g, _, targets = self._parse_target_list(
            self.conn.recv_response("query_store_all"))
        return g, targets

    def query_fetch_all(self, file_id: str) -> list[FetchTarget]:
        """Every replica currently safe to read this file (reference:
        QUERY_FETCH_ALL 105)."""
        group, _, remote = file_id.partition("/")
        self.conn.send_request(TrackerCmd.SERVICE_QUERY_FETCH_ALL,
                               pack_group_name(group) + remote.encode())
        _, _, targets = self._parse_target_list(
            self.conn.recv_response("query_fetch_all"))
        return targets

    # -- monitor / ops (JSON responses) ------------------------------------

    def list_groups(self) -> list[dict]:
        self.conn.send_request(TrackerCmd.SERVER_LIST_ALL_GROUPS)
        return json.loads(self.conn.recv_response("list_groups") or b"[]")

    def list_one_group(self, group: str) -> dict:
        self.conn.send_request(TrackerCmd.SERVER_LIST_ONE_GROUP,
                               pack_group_name(group))
        return json.loads(self.conn.recv_response("list_one_group") or b"{}")

    def get_parameters(self) -> dict[str, str]:
        """Cluster-global storage parameters (storage_param_getter.c)."""
        self.conn.send_request(TrackerCmd.STORAGE_PARAMETER_REQ)
        text = self.conn.recv_response("get_parameters").decode()
        out: dict[str, str] = {}
        for line in text.splitlines():
            key, _, value = line.partition("=")
            if key and _:
                out[key] = value
        return out

    def cluster_stat(self, group: str | None = None) -> dict:
        """One-RPC observability dump (SERVER_CLUSTER_STAT 95): tracker
        role/leader plus every group and storage with the full named
        last-beat stat payload.  Optional group filter."""
        body = pack_group_name(group) if group else b""
        self.conn.send_request(TrackerCmd.SERVER_CLUSTER_STAT, body)
        return json.loads(self.conn.recv_response("cluster_stat") or b"{}")

    def list_storages(self, group: str) -> list[dict]:
        self.conn.send_request(TrackerCmd.SERVER_LIST_STORAGE,
                               pack_group_name(group))
        return json.loads(self.conn.recv_response("list_storages") or b"[]")

    def delete_storage(self, group: str, ip: str, port: int) -> None:
        body = pack_group_name(group) + f"{ip}:{port}".encode()
        self.conn.send_request(TrackerCmd.SERVER_DELETE_STORAGE, body)
        self.conn.recv_response("delete_storage")

    def set_trunk_server(self, group: str, ip: str, port: int) -> None:
        """Operator override of the elected trunk server (cmd 94)."""
        body = pack_group_name(group) + f"{ip}:{port}".encode()
        self.conn.send_request(TrackerCmd.SERVER_SET_TRUNK_SERVER, body)
        self.conn.recv_response("set_trunk_server")

    # -- placement epoch / group lifecycle (fastdfs_tpu extension) ---------

    def query_placement(self) -> dict:
        """The placement epoch (QUERY_PLACEMENT 64): version + the ordered
        group list with lifecycle states and each group's ACTIVE members.
        Wire: 8B BE version + 8B BE entry count + per entry (16B group +
        1B state + 8B BE member count + per member (16B ip + 8B port))."""
        self.conn.send_request(TrackerCmd.QUERY_PLACEMENT)
        resp = self.conn.recv_response("query_placement")
        if len(resp) < 16:
            raise ProtocolError(f"short query_placement response: {len(resp)}")
        version = buff2long(resp, 0)
        count = buff2long(resp, 8)
        off = 16
        names = {0: "active", 1: "draining", 2: "retired"}
        groups = []
        for _ in range(count):
            if off + GROUP_NAME_MAX_LEN + 9 > len(resp):
                raise ProtocolError("truncated query_placement entry")
            group = unpack_group_name(resp[off:off + 16])
            state = resp[off + 16]
            members_n = buff2long(resp, off + 17)
            off += GROUP_NAME_MAX_LEN + 9
            rec = IP_ADDRESS_SIZE + 8
            if members_n < 0 or members_n > (len(resp) - off) // rec:
                raise ProtocolError(f"bad member count {members_n}")
            members = []
            for m in range(members_n):
                p = off + m * rec
                members.append({"ip": resp[p:p + 16].rstrip(b"\x00").decode(),
                                "port": buff2long(resp, p + 16)})
            off += members_n * rec
            groups.append({"group": group, "state": state,
                           "state_name": names.get(state, "?"),
                           "members": members})
        return {"version": version, "groups": groups}

    def query_hot_map(self, since_version: int | None = None) -> dict:
        """The elastic hot-replication map (QUERY_HOT_MAP 75): published
        hot entries and the extra replica groups serving each.  Empty
        body = full snapshot; 8B BE since_version = delta of changes
        after that version (a delta entry with zero groups is a
        tombstone — the key was demoted).  The tracker falls back to a
        full snapshot when the requested delta predates its changelog.
        Wire: 8B BE version + 1B full flag + 8B BE entry count + per
        entry (8B BE key_len + key + 8B BE group count + n x 16B group
        names)."""
        body = b"" if since_version is None else long2buff(since_version)
        self.conn.send_request(TrackerCmd.QUERY_HOT_MAP, body)
        resp = self.conn.recv_response("query_hot_map")
        if len(resp) < 17:
            raise ProtocolError(f"short query_hot_map response: {len(resp)}")
        version = buff2long(resp, 0)
        full = resp[8] != 0
        count = buff2long(resp, 9)
        off = 17
        entries = []
        for _ in range(count):
            if off + 8 > len(resp):
                raise ProtocolError("truncated query_hot_map entry")
            key_len = buff2long(resp, off)
            off += 8
            if key_len < 0 or off + key_len + 8 > len(resp):
                raise ProtocolError(f"bad hot-map key length {key_len}")
            key = resp[off:off + key_len].decode()
            off += key_len
            ngroups = buff2long(resp, off)
            off += 8
            if ngroups < 0 or \
                    ngroups > (len(resp) - off) // GROUP_NAME_MAX_LEN:
                raise ProtocolError(f"bad hot-map group count {ngroups}")
            groups = []
            for g in range(ngroups):
                p = off + g * GROUP_NAME_MAX_LEN
                groups.append(
                    unpack_group_name(resp[p:p + GROUP_NAME_MAX_LEN]))
            off += ngroups * GROUP_NAME_MAX_LEN
            entries.append({"key": key, "groups": groups})
        return {"version": version, "full": full, "entries": entries}

    def _group_admin(self, cmd: int, group: str, what: str) -> int:
        self.conn.send_request(cmd, pack_group_name(group))
        resp = self.conn.recv_response(what)
        if len(resp) < 8:
            raise ProtocolError(f"short {what} response: {len(resp)}")
        return buff2long(resp, 0)

    def group_drain(self, group: str) -> int:
        """Start draining a group (GROUP_DRAIN 65, tracker leader only):
        no new writes land there; its members migrate every file to its
        jump-hash home and the leader auto-retires the group when all
        report done.  Returns the new placement version."""
        return self._group_admin(TrackerCmd.GROUP_DRAIN, group, "group_drain")

    def group_reactivate(self, group: str) -> int:
        """Cancel a drain (GROUP_REACTIVATE 66, leader only).  Retired
        groups are refused (StatusError 22) — their data already moved.
        Returns the new placement version."""
        return self._group_admin(TrackerCmd.GROUP_REACTIVATE, group,
                                 "group_reactivate")

    def active_test(self) -> bool:
        self.conn.send_request(TrackerCmd.ACTIVE_TEST)
        self.conn.recv_response("active_test")
        return True

    def trace_dump(self) -> dict:
        """Span ring-buffer dump (TRACE_DUMP 96): this tracker's retained
        request spans.  Shape per fastdfs_tpu_torch.trace.decode_dump."""
        self.conn.send_request(TrackerCmd.TRACE_DUMP)
        return json.loads(self.conn.recv_response("trace_dump") or b"{}")

    def stat(self) -> dict:
        """The tracker's own stats-registry snapshot (STAT 97): event-loop
        lag, dispatched ops, request accounting.  Same JSON contract as
        the storage STAT (fastdfs_tpu.monitor.decode_registry)."""
        self.conn.send_request(TrackerCmd.STAT)
        return json.loads(self.conn.recv_response("stat") or b"{}")

    def event_dump(self) -> dict:
        """Flight-recorder dump (EVENT_DUMP 98): membership transitions
        and slow requests.  Shape per fastdfs_tpu.monitor.decode_events."""
        self.conn.send_request(TrackerCmd.EVENT_DUMP)
        return json.loads(self.conn.recv_response("event_dump") or b"{}")

    def health_matrix(self) -> dict:
        """Gray-failure differential matrix (HEALTH_MATRIX 69): every
        storage's self-reported gray score from its beat trailer against
        what its group peers score it, with the tracker's verdict
        (ok/gray/sick/unknown).  Shape per
        fastdfs_tpu.monitor.decode_health_matrix."""
        self.conn.send_request(TrackerCmd.HEALTH_MATRIX)
        return json.loads(self.conn.recv_response("health_matrix") or b"{}")

    def admission_status(self) -> dict:
        """Admission-ladder status (ADMISSION_STATUS 148): current shed
        level, pressure EWMA, per-class shed counts.  Shape per
        fastdfs_tpu.monitor.decode_admission."""
        self.conn.send_request(TrackerCmd.ADMISSION_STATUS)
        return json.loads(self.conn.recv_response("admission_status")
                          or b"{}")

    def metrics_history(self, since_us: int = 0) -> dict:
        """Metrics-journal window dump (METRICS_HISTORY 99): the
        tracker's retained registry snapshots with ts_us >= since_us
        (0 = all).  Shape per
        fastdfs_tpu.monitor.decode_metrics_history; StatusError(95)
        when journaling is off."""
        body = long2buff(since_us) if since_us else b""
        self.conn.send_request(TrackerCmd.METRICS_HISTORY, body)
        return json.loads(self.conn.recv_response("metrics_history") or b"{}")

    def profile_start(self, hz: int = 97, duration_s: int = 30) -> dict:
        """Arm the tracker's sampling profiler (PROFILE_CTL 67); same
        contract as StorageClient.profile_start — ack {"active", "hz"},
        StatusError(95) when profile_max_hz = 0, auto-disarm at the
        duration deadline."""
        self.conn.send_request(TrackerCmd.PROFILE_CTL,
                               pack_profile_ctl(True, hz, duration_s))
        return json.loads(self.conn.recv_response("profile_start") or b"{}")

    def profile_stop(self) -> dict:
        """Disarm early (PROFILE_CTL 67, action 0); idempotent, samples
        kept for profile_dump."""
        self.conn.send_request(TrackerCmd.PROFILE_CTL,
                               pack_profile_ctl(False))
        return json.loads(self.conn.recv_response("profile_stop") or b"{}")

    def profile_dump(self) -> dict:
        """Folded-stack dump (PROFILE_DUMP 68).  Shape per
        fastdfs_tpu.monitor.decode_profile; StatusError(95) while no
        capture was ever started."""
        self.conn.send_request(TrackerCmd.PROFILE_DUMP)
        return json.loads(self.conn.recv_response("profile_dump") or b"{}")

    def get_tracker_status(self) -> dict:
        """Multi-tracker relationship probe (TRACKER_GET_STATUS 70):
        whether this tracker is the leader and who it believes leads."""
        self.conn.send_request(TrackerCmd.TRACKER_GET_STATUS)
        resp = self.conn.recv_response("get_tracker_status")
        if len(resp) < 1 + IP_ADDRESS_SIZE + 8:
            raise ProtocolError(f"short tracker status: {len(resp)}")
        ip = resp[1:17].rstrip(b"\x00").decode()
        port = buff2long(resp, 17)
        leader = f"{ip}:{port}" if ip and port > 0 else ""
        return {"am_leader": resp[0] == 1, "leader": leader}
