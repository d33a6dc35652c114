"""The tracker-routed cluster on the port: one ``fdfs_trackerd`` and two
``fdfs_storaged`` in one group, each storage with ``dedup_mode =
sidecar`` on its own port sidecar, driven by the port's ``FdfsClient``,
``trace``, ``monitor`` and ``cli`` on the CPU.

These are the live cases of ``tests/test_dedup_upload.py`` (the
negotiated upload: a warm re-upload ships no chunk bytes, the file
replicates and a wiped replica recovers it, the fallbacks, session
expiry, concurrency, the sidecar's reindex), run tracker-routed through
the port, plus ``traced_upload`` and ``collect_cluster_spans`` across
the three daemons, ``cli upload --dedup`` through the tracker, and the
monitor's live rows.  The daemons come from ``tests/torch_native.py``
(which builds the tracker where the host's g++ rejects the full tree).

Each sidecar starts through the launcher of ``tests/test_torch_live.py``
(SHA-1 by hashlib: the plain twin is too slow for the daemon's RPC
timeout; the sketch runs its plain twin).  The daemons fail open to
flat files when a sidecar does not answer, so the tests check recipes
and the sidecars' counters, not downloads alone.  Every wait has its own
deadline, and every test its own time limit.
"""

import contextlib
import io
import os
import shutil
import socket
import threading
import time
import zlib

import numpy as np
import pytest

from fastdfs_tpu import cli as R_cli
from fastdfs_tpu_torch import cli as T_cli
from fastdfs_tpu_torch import monitor as T_mon
from fastdfs_tpu_torch import trace as T_trace
from fastdfs_tpu_torch.client import (FdfsClient, StorageClient,
                                      TrackerClient, fingerprint_buffer)
from fastdfs_tpu_torch.client.conn import ProtocolError, StatusError
from fastdfs_tpu_torch.client.storage_client import (
    pack_upload_recipe, unpack_upload_recipe_resp)
from fastdfs_tpu_torch.common.protocol import (HEADER_SIZE, StorageCmd,
                                               pack_header, unpack_header)
from tests import torch_native
from tests.harness import chunk_digests, recipe_keys
from tests.test_torch_live import PortSidecar, time_limit
from tests.torch_native import start_storage as _start_storage
from tests.torch_native import start_tracker as _start_tracker

HB = "heart_beat_interval = 1\nstat_report_interval = 1"
SCRUB = "scrub_interval_s = 0\nchunk_gc_grace_s = 1"
# The shared cluster runs without the admission ladder: on a loaded host
# it sheds the peer's replication (background class) with EBUSY, and the
# daemon's sync sender then skips that file for good
# (native/storage/sync.cc, "rejected by peer ... skipping").
NO_SHED = "admission_control = 0"
IPS = ("127.0.0.61", "127.0.0.62")


def _wait(cond, timeout=60.0, interval=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(interval)
    return None


def _payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _is_recipe(base, fid):
    return os.path.basename(fid) + ".rcp" in recipe_keys(base)


class Cluster:
    """A tracker and two storages on the port's sidecars."""

    def __init__(self, root):
        self.storaged, trackerd, _ = torch_native.native_binaries()
        self.tracker = self.sidecars = None
        self.storages, self.bases = [], []
        try:
            self.tracker = _start_tracker(trackerd, os.path.join(root, "tr"))
            self.taddr = f"127.0.0.1:{self.tracker.port}"
            self.sidecars = []
            for i in range(2):
                os.makedirs(os.path.join(root, f"sc{i}"))
                self.sidecars.append(PortSidecar(os.path.join(root,
                                                              f"sc{i}")))
            for i, ip in enumerate(IPS):
                self.bases.append(os.path.join(root, f"st{i}"))
                self.storages.append(self._storage(i))
            self.t = TrackerClient("127.0.0.1", self.tracker.port)
            assert _wait(self.active, timeout=30), "storages never ACTIVE"
            self.cli = FdfsClient([self.taddr], timeout=60.0, device="cpu")
            assert self.cli.upload_buffer(b"warmup " * 64, ext="bin")
        except BaseException:
            self.close()
            raise

    def _storage(self, i, port=None):
        return _start_storage(self.storaged, self.bases[i], ip=IPS[i],
                              port=port, trackers=[self.taddr],
                              dedup_mode="sidecar",
                              dedup_sidecar=self.sidecars[i].sock,
                              extra=HB + "\n" + SCRUB + "\n" + NO_SHED)

    def active(self):
        groups = self.t.list_groups()
        return bool(groups) and groups[0]["active"] == 2

    def sc(self, i):
        return StorageClient(IPS[i], self.storages[i].port, timeout=60.0,
                             device="cpu")

    def replicated(self, fid):
        return len(self.t.query_fetch_all(fid)) == 2

    def fingerprinted(self):
        return [s.stats()["fingerprint_bytes"] for s in self.sidecars]

    def close(self):
        for d in self.storages:
            d.stop()
        if self.tracker is not None:
            self.tracker.stop()
        for s in self.sidecars or []:
            s.kill()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("cluster")))
    yield c
    c.cli.close()
    c.close()


def test_warm_negotiated_reupload_ships_nothing_and_replicates(cluster):
    """The acceptance path: the warm re-upload ships zero chunk bytes, the
    ID downloads byte-identical from both storages, each file is a
    recipe, and the wire savings show in the daemons' counters."""
    with time_limit(120):
        c = cluster
        payload = _payload(1, 256 * 1024)
        first, second = {}, {}
        fid1 = c.cli.upload_buffer_dedup(payload, ext="bin", min_dup_ratio=0,
                                         stats=first)
        assert _wait(lambda: c.replicated(fid1)), "fid1 never replicated"
        fid2 = c.cli.upload_buffer_dedup(payload, ext="bin", min_dup_ratio=0,
                                         stats=second)
        assert first["fallback"] == "" and second["fallback"] == ""
        assert first["bytes_sent"] == len(payload)
        assert second["chunks_missing"] == 0 and second["bytes_sent"] == 0
        assert second["chunks_total"] > 1
        assert c.cli.download_to_buffer(fid1) == payload
        assert c.cli.download_to_buffer(fid2) == payload

        def saved():
            total = 0
            for i in range(2):
                with c.sc(i) as sc:
                    total += sc.stat()["counters"].get(
                        "ingest.bytes_saved_wire", 0)
            return total
        assert saved() >= 0.9 * len(payload), saved()

        # Below the daemon's dedup_chunk_threshold (64 KiB): ENOTSUP,
        # and the client falls back to a plain upload.
        small, small_stats = _payload(2, 16 * 1024), {}
        with c.sc(0) as sc:
            fid_small = sc.upload_buffer_dedup(small, ext="bin",
                                               stats=small_stats)
            assert small_stats["fallback"] == "status95"
            assert sc.download_to_buffer(fid_small) == small

        assert _wait(lambda: c.replicated(fid2)), "fid2 never replicated"
        for i in range(2):
            with c.sc(i) as sc:
                assert sc.download_to_buffer(fid2) == payload
                assert sc.download_to_buffer(fid1, 1000, 4321) == \
                    payload[1000:5321]
            for fid in (fid1, fid2):
                assert _is_recipe(c.bases[i], fid), (i, fid)


def test_negotiated_upload_is_reindexed_for_near_dups(cluster):
    """The client's fingerprint never reaches the sidecar: the daemon
    feeds a negotiated upload through its sidecar (the reindex), or
    NEAR_DUPS would not see it.  Each storage's sidecar indexes only the
    files that storage took (a replica does not fingerprint what it
    syncs), so A goes in twice, once through each storage."""
    with time_limit(120):
        c = cluster
        base = _payload(33, 1 << 20)
        variant = base[:(1 << 20) - 4096] + _payload(34, 4096)
        before = c.fingerprinted()
        fids_a = {c.cli.upload_buffer(base, ext="bin") for _ in range(2)}
        assert all(_wait(lambda: c.replicated(f)) for f in fids_a)
        assert [a - b for a, b in zip(c.fingerprinted(), before)] == \
            [len(base)] * 2, "A did not go through both sidecars"
        before = c.fingerprinted()
        stats = {}
        fid_b = c.cli.upload_buffer_dedup(variant, ext="bin",
                                          min_dup_ratio=0, stats=stats)
        assert stats["fallback"] == ""
        assert stats["chunks_missing"] < stats["chunks_total"]
        after = c.fingerprinted()
        assert sum(after) - sum(before) == len(variant), (before, after)
        near = _wait(lambda: [p for p in c.cli.near_dups(fid_b)
                              if p[0] in fids_a], timeout=20)
        assert near, f"negotiated upload invisible: {c.cli.near_dups(fid_b)}"
        assert c.cli.download_to_buffer(fid_b) == variant


def test_replicas_store_recipes_without_fingerprinting_again(cluster):
    """A plain upload is fingerprinted once, by the storage that took it;
    chunk-aware sync builds the replica's recipe from the source's chunk
    list, so the replica's sidecar sees none of it."""
    with time_limit(120):
        c = cluster
        data = _payload(5, 700_001)
        before = c.fingerprinted()
        fid = c.cli.upload_buffer(data, ext="bin")
        assert _wait(lambda: c.replicated(fid)), "never replicated"
        time.sleep(1.0)    # any late sync work would show by now
        after = c.fingerprinted()
        grew = [a - b for a, b in zip(after, before)]
        assert sorted(grew) == [0, len(data)], grew
        for i in range(2):
            assert _is_recipe(c.bases[i], fid)
            with c.sc(i) as sc:
                assert sc.download_to_buffer(fid) == data


def test_traced_upload_stitches_tracker_and_both_storages(cluster):
    with time_limit(120):
        c = cluster
        data = _payload(6, 300_000)
        fid, tracer = T_trace.traced_upload(c.cli, data, ext="bin")
        assert _wait(lambda: c.replicated(fid)), "never replicated"

        def stitched():
            spans, errors = T_trace.collect_cluster_spans(c.cli)
            assert errors == {}
            mine = [s for s in spans + tracer.spans
                    if s.trace_id == tracer.trace_id]
            nodes = {s.node.split()[0] + " " + s.node.split()[-1]
                     .rsplit(":", 1)[0] for s in mine}
            return mine if len(nodes) == 4 else None
        spans = _wait(stitched, timeout=20)
        assert spans, "the trace never reached the tracker and both storages"
        root = [s for s in spans if s.name == "client.upload"]
        assert len(root) == 1 and root[0].parent_id == 0
        by_node = {}
        for s in spans:
            by_node.setdefault(s.node.rsplit(":", 1)[0], []).append(s.name)
        assert "tracker.query_store" in by_node["tracker 127.0.0.1"]
        source = [n for n, names in by_node.items()
                  if "storage.upload_file" in names]
        assert len(source) == 1 and "storage.fingerprint" in by_node[
            source[0]]
        assert {f"storage {ip}" for ip in IPS} <= set(by_node)
        text = T_trace.render_timeline(spans, tracer.trace_id)
        assert text.splitlines()[0].startswith(
            f"trace {tracer.trace_id:016x}  spans={len(spans)} nodes=4")


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_upload_dedup_through_the_tracker(cluster, tmp_path):
    with time_limit(120):
        c = cluster
        data = _payload(7, 300_000)
        path = tmp_path / "file.bin"
        path.write_bytes(data)
        rc, out, err = _run_cli(T_cli.main, ["--device", "cpu", "upload",
                                             c.taddr, "--dedup", str(path)])
        assert rc == 0, err
        fid = out.strip()
        assert err == f"wire: {len(data)}/{len(data)} bytes shipped\n"
        assert c.cli.download_to_buffer(fid) == data
        assert _wait(lambda: c.replicated(fid)), "never replicated"
        # Warm: the port's CLI and the reference's both ship nothing.
        for main, prefix in ((T_cli.main, ["--device", "cpu"]),
                             (R_cli.main, [])):
            rc, out2, err2 = _run_cli(main, prefix + [
                "upload", c.taddr, "--dedup", str(path)])
            assert rc == 0, err2
            assert err2 == f"wire: 0/{len(data)} bytes shipped\n"
            assert c.cli.download_to_buffer(out2.strip()) == data
        rc, out, err = _run_cli(T_cli.main, ["--device", "cpu", "download",
                                             c.taddr, fid,
                                             str(tmp_path / "back.bin")])
        assert rc == 0 and (tmp_path / "back.bin").read_bytes() == data


def test_monitor_and_cli_render_both_storages_live(cluster):
    with time_limit(120):
        c = cluster
        addrs = [f"{ip}:{d.port}" for ip, d in zip(IPS, c.storages)]
        top = T_mon.gather_top(c.cli)
        for addr in addrs:
            node = top.nodes[f"storage {addr}"]
            assert node.error == "" and node.registry is not None
        assert not [n for n, s in top.nodes.items() if s.error]
        rates = T_mon.top_rates(None, top)
        frame = T_mon.render_top(top, rates, top.events)
        assert "DOWN" not in frame and all(a in frame for a in addrs)
        snap = T_mon.gather(c.cli)
        assert snap.storage_errors == {} and set(snap.storage_stats) == \
            set(addrs)
        for argv in (["monitor"], ["group", "status"], ["health", "--detail"],
                     ["admission"]):
            rc, out, err = _run_cli(T_cli.main, ["--device", "cpu", argv[0],
                                                 c.taddr, *argv[1:]])
            assert rc == 0, (argv, out, err)
            assert "error" not in out + err, (argv, out, err)
            if argv[0] != "group":
                assert all(a in out for a in addrs), (argv, out)


def _on_both_storages(c, fid) -> bool:
    """Both storages hold ``fid``.  The tracker routes a read to a replica
    once the replica's sync has reached the file's create second, which
    can come before the sync has written the file itself (ROADMAP, Queue
    3): a read routed there answers status 2."""
    for i in range(2):
        try:
            with c.sc(i) as sc:
                sc.query_file_info(fid)
        except StatusError as e:
            if e.status != 2:
                raise
            return False
    return True


def test_concurrent_negotiated_uploads_and_deletes(cluster):
    """Pin/ref discipline under concurrency: negotiated uploads sharing
    chunks race deletes of earlier files; every surviving file reaches
    both storages and downloads byte-identical through the tracker and
    from each storage, and no session leaks."""
    with time_limit(150):
        c = cluster
        shared = _payload(8, 160 * 1024)
        errors: list[str] = []

        def worker(i):
            cli = FdfsClient([c.taddr], timeout=60.0, device="cpu")
            try:
                kept = []
                for j in range(3):
                    data = shared + _payload(100 + 10 * i + j,
                                             4096 * (i + 1) + j)
                    fid = cli.upload_buffer_dedup(data, ext="bin",
                                                  min_dup_ratio=0)
                    kept.append((fid, data))
                    if j % 2 == 1:
                        cli.delete_file(kept.pop(0)[0])
                for fid, data in kept:
                    if not _wait(lambda: _on_both_storages(c, fid),
                                 timeout=60):
                        errors.append(f"worker {i}: {fid} never reached "
                                      f"both storages")
                        continue
                    if cli.download_to_buffer(fid) != data:
                        errors.append(f"worker {i}: {fid} corrupt")
                    for k in range(2):
                        with c.sc(k) as sc:
                            if sc.download_to_buffer(fid) != data:
                                errors.append(f"worker {i}: {fid} corrupt "
                                              f"on storage {k}")
            except Exception as e:  # noqa: BLE001 — surface, don't hang
                errors.append(f"worker {i}: {e!r}")
            finally:
                cli.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors

        def idle():
            for i in range(2):
                with c.sc(i) as sc:
                    if sc.stat()["gauges"].get("ingest.sessions_active",
                                               -1) != 0:
                        return False
            return True
        assert _wait(idle, timeout=15), "sessions leaked"


def _recovered(ip, port, fid, payload):
    try:
        with StorageClient(ip, port, timeout=10.0, device="cpu") as sc:
            return sc.download_to_buffer(fid) == payload
    except (OSError, ProtocolError, StatusError):
        return False


def test_wiped_replica_recovers_the_negotiated_upload(cluster):
    """Last on the shared cluster: wipe storage 2's data (keeping its
    sync state) and restart it; the rebuilt node serves the negotiated
    upload byte-identical, as a recipe, and its sidecar indexes what the
    recovery rebuilt."""
    with time_limit(150):
        c = cluster
        payload = _payload(9, 300_000)
        fid = c.cli.upload_buffer_dedup(payload, ext="bin", min_dup_ratio=0)
        assert _wait(lambda: c.replicated(fid)), "never replicated"
        port = c.storages[1].port
        c.storages[1].stop()
        indexed = c.sidecars[1].stats()["fingerprint_bytes"]
        data_dir = os.path.join(c.bases[1], "data")
        for name in os.listdir(data_dir):
            if name == "sync":
                continue
            p = os.path.join(data_dir, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)
        c.storages[1] = c._storage(1, port=port)
        assert _wait(lambda: _recovered(IPS[1], port, fid, payload),
                     timeout=60), "the wiped node never served the file"
        assert _is_recipe(c.bases[1], fid)
        # Recovery re-registers what it rebuilds with the node's sidecar.
        assert _wait(lambda: c.sidecars[1].stats()["fingerprint_bytes"]
                     - indexed >= len(payload), timeout=30)


def test_negotiated_upload_falls_back_without_chunk_store(tmp_path):
    """A storage with dedup off answers ENOTSUP to the negotiated
    opcodes; the port's client re-sends the file as a plain upload."""
    storaged, trackerd, _ = torch_native.native_binaries()
    with time_limit(120):
        tracker = _start_tracker(trackerd, str(tmp_path / "tr"))
        taddr = f"127.0.0.1:{tracker.port}"
        storage = None
        try:
            storage = _start_storage(storaged, str(tmp_path / "st"),
                                     trackers=[taddr], dedup_mode="none",
                                     extra=HB)
            cli = FdfsClient([taddr], dedup_uploads=True, dedup_min_ratio=0.0,
                             device="cpu")
            payload = _payload(10, 128 * 1024)
            assert _wait(lambda: _try_upload(cli, b"warmup " * 64))
            stats = {}
            fid = cli.upload_buffer_dedup(payload, ext="bin",
                                          min_dup_ratio=0, stats=stats)
            assert stats["fallback"] == "status95"
            assert cli.download_to_buffer(fid) == payload
            fid2 = cli.upload_buffer(payload, ext="bin")   # the opt-in path
            assert cli.download_to_buffer(fid2) == payload
            with StorageClient("127.0.0.1", storage.port,
                               device="cpu") as sc:
                counters = sc.stat()["counters"]
            assert counters.get("ingest.recipe_fallbacks", 0) >= 1
            cli.close()
        finally:
            if storage is not None:
                storage.stop()
            tracker.stop()


def _try_upload(cli, data):
    try:
        return cli.upload_buffer(data, ext="bin")
    except (OSError, ProtocolError, StatusError):
        return None


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("peer closed")
        buf += got
    return buf


def test_upload_session_timeout_releases_pins(tmp_path):
    """A client that sends UPLOAD_RECIPE and vanishes leaks no pins: the
    chunks it held present survive a delete only until the session sweep
    fires, then their deferred unlink completes."""
    storaged, trackerd, _ = torch_native.native_binaries()
    with time_limit(120):
        tracker = _start_tracker(trackerd, str(tmp_path / "tr"))
        taddr = f"127.0.0.1:{tracker.port}"
        stdir = str(tmp_path / "st")
        storage = None
        try:
            storage = _start_storage(storaged, stdir, trackers=[taddr],
                                     dedup_mode="cpu",
                                     extra=HB + "\nupload_session_timeout = 1")
            cli = FdfsClient([taddr], device="cpu")
            payload = _payload(11, 128 * 1024)
            assert _wait(lambda: _try_upload(cli, b"warmup " * 64))
            fid = cli.upload_buffer_dedup(payload, ext="bin",
                                          min_dup_ratio=0)
            n_chunks = len(chunk_digests(stdir))
            assert n_chunks > 0

            def counters():
                with StorageClient("127.0.0.1", storage.port,
                                   device="cpu") as sc:
                    reg = sc.stat()
                return (reg["counters"],
                        reg["gauges"].get("ingest.sessions_active", -1))

            chunks = [(fp.length, fp.digest)
                      for fp in fingerprint_buffer(payload, device="cpu")]
            body = pack_upload_recipe(0xFF, "bin", zlib.crc32(payload),
                                      len(payload), chunks)
            sock = socket.create_connection(("127.0.0.1", storage.port),
                                            timeout=10)
            try:
                sock.sendall(pack_header(len(body), StorageCmd.UPLOAD_RECIPE)
                             + body)
                hdr = unpack_header(_recv_exact(sock, HEADER_SIZE))
                resp = _recv_exact(sock, hdr.pkg_len)
                assert hdr.status == 0
                _, bitmap = unpack_upload_recipe_resp(resp, len(chunks))
                assert bitmap == b"\x00" * len(chunks)
                assert counters()[1] == 1
                cli.delete_file(fid)
                assert len(chunk_digests(stdir)) == n_chunks, \
                    "pinned chunks were unlinked by delete"
            finally:
                sock.close()                       # the vanished client
            assert _wait(lambda: counters()[1] == 0, timeout=10)
            assert _wait(lambda: len(chunk_digests(stdir)) == 0, timeout=10), \
                "deferred unlinks never completed after session expiry"
            assert counters()[0].get("ingest.recipe_fallbacks", 0) >= 1
            cli.close()
        finally:
            if storage is not None:
                storage.stop()
            tracker.stop()
