"""CLI tools over the client library.

Reference: the L4 tools in ``client/`` — fdfs_upload_file.c,
fdfs_download_file.c, fdfs_delete_file.c, fdfs_file_info.c,
fdfs_monitor.c (cluster status), fdfs_test.c (full-API smoke).

The port's copy of ``fastdfs_tpu/cli.py``, over the port's client, with
one choice more: an optional leading ``--device cuda|cpu`` names where
``upload --dedup`` fingerprints (``cuda`` unless given; asking for CUDA
where there is none raises before any socket opens).  Every other
argument, output line and exit code is the reference's.

Usage:  python -m fastdfs_tpu_torch.cli [--device cuda|cpu] <tool>
            <client.conf|tracker host:port> [args]
"""

from __future__ import annotations

import json
import os
import sys

from fastdfs_tpu_torch.client import FdfsClient
from fastdfs_tpu_torch.client.conn import StatusError
from fastdfs_tpu_torch.common.fileid import decode_file_id
from fastdfs_tpu_torch.ops import resolve_device


def _client(conf_or_addr: str, device) -> FdfsClient:
    if os.path.exists(conf_or_addr):
        return FdfsClient.from_conf(conf_or_addr, device=device)
    return FdfsClient(conf_or_addr, device=device)


def _flag(args: list[str], name: str, default: str | None = None):
    """`--name value` lookup shared by the flag-taking subcommands; a
    following token that is itself a flag does not count as a value."""
    if name in args:
        i = args.index(name)
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            return args[i + 1]
    return default


def cmd_upload(c: FdfsClient, args: list[str]) -> int:
    if not args:
        print("usage: upload <tracker> [--dedup] <local_file> [ext]",
              file=sys.stderr)
        return 2
    dedup = args[0] == "--dedup"
    if dedup:
        args = args[1:]
        if not args:
            print("usage: upload <tracker> [--dedup] <local_file> [ext]",
                  file=sys.stderr)
            return 2
    path = args[0]
    ext = args[1] if len(args) > 1 else os.path.splitext(path)[1].lstrip(".")[:6]
    with open(path, "rb") as fh:
        data = fh.read()
    if dedup:
        # Negotiated upload: fingerprint locally, ship only chunks the
        # daemon lacks; report the wire savings alongside the file ID.
        stats: dict = {}
        fid = c.upload_buffer_dedup(data, ext=ext, min_dup_ratio=0,
                                    stats=stats)
        print(fid)
        sent = stats.get("bytes_sent", len(data))
        print(f"wire: {sent}/{len(data)} bytes shipped"
              + (f" (fallback: {stats['fallback']})"
                 if stats.get("fallback") else ""), file=sys.stderr)
    else:
        fid = c.upload_buffer(data, ext=ext)
        print(fid)
    return 0


def cmd_download(c: FdfsClient, args: list[str]) -> int:
    usage = ("usage: download <tracker> [--parallel N] <file_id> "
             "[local_path]")
    parallel = 1
    if args and args[0] == "--parallel":
        if len(args) < 2 or not args[1].isdigit():
            print(usage, file=sys.stderr)
            return 2
        parallel = int(args[1])
        args = args[2:]
    if not args:
        print(usage, file=sys.stderr)
        return 2
    fid = args[0]
    out = args[1] if len(args) > 1 else os.path.basename(fid)
    # Single-stream downloads go through download_stream (O(segment)
    # client memory); --parallel N splits into jump-hash-routed ranges
    # fetched concurrently across the group's replicas.
    n = c.download_to_file(fid, out, parallel=parallel)
    print(f"{out}: {n} bytes" + (f" (parallel={parallel})"
                                 if parallel > 1 else ""))
    return 0


def cmd_delete(c: FdfsClient, args: list[str]) -> int:
    if not args:
        print("usage: delete <tracker> <file_id>", file=sys.stderr)
        return 2
    c.delete_file(args[0])
    print("deleted")
    return 0


def cmd_file_info(c: FdfsClient, args: list[str]) -> int:
    """Client-side ID decode + server-side query (fdfs_file_info.c)."""
    if not args:
        print("usage: file_info <tracker> <file_id>", file=sys.stderr)
        return 2
    fid, info = decode_file_id(args[0])
    print(f"group: {fid.group}\nstore path: M{fid.store_path_index:02X}")
    print(f"source ip: {info.source_ip}\ncreate time: {info.create_timestamp}")
    print(f"file size: {info.file_size}\ncrc32: {info.crc32:08X}")
    print(f"appender: {info.appender}  trunk: {info.trunk}  slave: {info.slave}")
    remote = c.query_file_info(args[0])
    print(f"server-reported size: {remote.file_size}")
    return 0


def cmd_monitor(c: FdfsClient, args: list[str]) -> int:
    """Cluster health (fdfs_monitor.c analogue): tracker role, per-group
    capacity, per-storage liveness with named beat stats, and each
    daemon's per-opcode counters from its STAT registry.

    Flags: --prometheus  emit text exposition format for scraping
           --no-storage-stats  skip the per-daemon STAT round-trips
           --group <name>      limit to one group
    """
    from fastdfs_tpu_torch import monitor as M
    group = None
    if "--group" in args:
        i = args.index("--group")
        if i + 1 >= len(args) or args[i + 1].startswith("--"):
            print("usage: monitor <tracker> [--group <name>] [--prometheus] "
                  "[--no-storage-stats]", file=sys.stderr)
            return 2
        group = args[i + 1]
    snap = M.gather(c, with_storage_stats="--no-storage-stats" not in args,
                    group=group)
    if "--prometheus" in args:
        print(M.to_prometheus(snap), end="")
    else:
        print(M.render_text(snap))
    return 0


def cmd_top(c: FdfsClient, args: list[str]) -> int:
    """Live cluster saturation dashboard (fdfs_top): polls STAT +
    SERVER_CLUSTER_STAT + EVENT_DUMP across every node on an interval,
    computes delta RATES (ops/s, MB/s, cache hit %, nio loop-lag p99,
    dio queue-wait p99 from histogram deltas), and renders a refreshing
    per-node table plus a scrolling recent-events pane — the operator
    console the load harness runs against.

    Flags: --interval s   poll cadence (default 2)
           --count N      render N frames then exit (0 = forever;
                          scripts and tests use this)
           --group <name> limit the storage rows to one group
           --events N     events-pane depth (default 10)
           --heat [N]     per-node hot-file pane (HEAT_TOP; top N rows,
                          default 5)
           --threads [N]  per-node THREADS pane: the thread ledger from
                          the thread.* gauges already in each STAT
                          snapshot (top N by cpu%, default 8; no extra
                          RPC)
           --json         one machine-readable JSON object per frame
                          instead of the table
           --no-clear     never emit the ANSI clear (append frames)

    An ALERTS line appears whenever a node has active SLO breaches
    (slo.breach events raise a rule, slo.recovered clears it; the
    slo.breaches_active gauge backs the count for nodes whose breach
    predates this fdfs_top's first frame).
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    def flag(name, default=None):
        return _flag(args, name, default)

    interval = float(flag("--interval", "2"))
    count = int(flag("--count", "0"))
    group = flag("--group")
    max_events = int(flag("--events", "10"))
    with_heat = "--heat" in args
    heat_rows = int(flag("--heat", "5") or 5) if with_heat else 5
    with_threads = "--threads" in args
    thread_rows = int(flag("--threads", "8") or 8) if with_threads else 8
    as_json = "--json" in args
    clear = "--no-clear" not in args and not as_json and sys.stdout.isatty()

    seen_seq: dict[str, tuple[int, int]] = {}
    recent: list[M.ClusterEvent] = []
    active_alerts: dict[str, set] = {}
    prev = None
    frames = 0
    try:
        while True:
            cur = M.gather_top(c, group=group, seen_seq=seen_seq)
            rates = M.top_rates(prev, cur)
            recent.extend(sorted(cur.events, key=lambda e: e.ts_us))
            del recent[:-200]  # bounded scrollback
            # Alert tracking: breach raises a rule on its node, recovery
            # clears it (events are seq-deduped, so replays can't flap).
            # Reconcile against the authoritative gauge BEFORE applying
            # this frame's events: a daemon that restarted after a breach
            # never emits slo.recovered (its evaluator state died with
            # it), so a node whose live slo.breaches_active reads 0 has
            # nothing red by definition.  Gauge-clear first, then events
            # — a breach landing between the STAT and EVENT_DUMP calls
            # still sticks.
            for node, ns in cur.nodes.items():
                if (ns.registry is not None and not
                        ns.registry["gauges"].get("slo.breaches_active")):
                    active_alerts.pop(node, None)
            for e in sorted(cur.events, key=lambda ev: (ev.ts_us, ev.seq)):
                if e.type == "slo.breach":
                    active_alerts.setdefault(e.node, set()).add(e.key)
                elif e.type == "slo.recovered":
                    active_alerts.get(e.node, set()).discard(e.key)
            alerts = {n: sorted(rules)
                      for n, rules in active_alerts.items() if rules}
            heat = None
            if with_heat:
                heat = {}
                for node, ns in cur.nodes.items():
                    if ns.role != "storage" or ns.registry is None:
                        continue
                    ip, _, port = ns.addr.rpartition(":")
                    try:
                        heat[node] = M.decode_heat(
                            c.storage_heat_top(ip, int(port), heat_rows))
                    except Exception:  # noqa: BLE001 — heat off / old node
                        heat[node] = []
            threads = None
            if with_threads:
                threads = {node: M.thread_ledger(ns.registry)
                           for node, ns in cur.nodes.items()
                           if ns.registry is not None}
            # HOT line data: the tracker's published hot map (elastic
            # replication); best-effort — an old tracker has no opcode.
            try:
                hot_map = c.query_hot_map()
            except Exception:  # noqa: BLE001
                hot_map = None
            if as_json:
                print(json.dumps({
                    "ts": cur.ts,
                    "nodes": rates,
                    "events": [vars(e) for e in cur.events],
                    "alerts": alerts,
                    "heat": ({n: [vars(h) for h in hs]
                              for n, hs in heat.items()}
                             if heat is not None else None),
                    "threads": ({n: rows[:thread_rows]
                                 for n, rows in threads.items()}
                                if threads is not None else None),
                    "hot_map": hot_map,
                }, sort_keys=True), flush=True)
            else:
                frame = M.render_top(cur, rates, recent, max_events,
                                     alerts=alerts, heat=heat,
                                     heat_rows=heat_rows, threads=threads,
                                     thread_rows=thread_rows,
                                     hot_map=hot_map)
                if clear:
                    print("\x1b[2J\x1b[H" + frame, flush=True)
                else:
                    print(frame, flush=True)
            prev = cur
            frames += 1
            if count and frames >= count:
                return 0
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_report(c: FdfsClient, args: list[str]) -> int:
    """fdfs_report: retrospective observability from the metrics
    journals (METRICS_HISTORY) — per-node rate/latency time-series over
    a window, the SLO breach timeline from the flight recorders, and
    per-node hot-file tables (HEAT_TOP).  Works after a crash or
    restart: the journal is on disk, so `--since <pre-crash>` replays
    the telemetry that led into the failure.

    Flags: --since <t>    window start: seconds-ago when < 10^7 (e.g.
                          `--since 600` = the last 10 minutes), else an
                          absolute unix-seconds stamp (as printed by
                          `date +%s`).  Default: everything retained.
           --group <name> limit to one group's storages
           --rows N       intervals shown per node (default 12)
           --heat-k N     heat rows requested/rendered (default 5)
           --json         machine-readable dump instead of the tables
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    def flag(name, default=None):
        return _flag(args, name, default)

    since_us = 0
    raw_since = flag("--since")
    if raw_since is not None:
        v = float(raw_since)
        if v <= 0:
            print("--since must be positive", file=sys.stderr)
            return 2
        epoch_s = _time.time() - v if v < 1e7 else v
        since_us = int(epoch_s * 1e6)
    group = flag("--group")
    rows = int(flag("--rows", "12"))
    heat_k = int(flag("--heat-k", "5"))

    data = M.gather_report(c, since_us=since_us, group=group, heat_k=heat_k)
    if not data.history and data.errors:
        # Nothing reachable carried a journal: that is a failure, not an
        # empty report.
        for node, err in sorted(data.errors.items()):
            print(f"{node}  error: {err}", file=sys.stderr)
        return 1
    if "--json" in args:
        print(json.dumps({
            "since_us": data.since_us,
            "series": {n: M.report_series(h)
                       for n, h in data.history.items()},
            "snapshots": {n: len(h) for n, h in data.history.items()},
            "breaches": [vars(e) for e in
                         M.breach_timeline(data.events, data.since_us,
                                           data.history)],
            "heat": {n: [vars(h) for h in hs]
                     for n, hs in data.heat.items()},
            "errors": data.errors,
        }, sort_keys=True))
    else:
        print(M.render_report(data, max_rows=rows, heat_rows=heat_k))
    return 0 if not data.errors else 1


def cmd_test(c: FdfsClient, args: list[str]) -> int:
    """Full-API smoke (fdfs_test.c): upload + metadata + query + download +
    delete."""
    data = os.urandom(10000)
    fid = c.upload_buffer(data, ext="bin")
    print(f"upload: {fid}")
    c.set_metadata(fid, {"from": "fdfs_test", "len": str(len(data))})
    print(f"metadata: {c.get_metadata(fid)}")
    info = c.query_file_info(fid)
    print(f"file info: size={info.file_size} ip={info.source_ip}")
    assert c.download_to_buffer(fid) == data
    print("download: OK")
    c.delete_file(fid)
    print("delete: OK")
    return 0


def cmd_groups_json(c: FdfsClient, args: list[str]) -> int:
    print(json.dumps(c.list_groups(), indent=2))
    return 0


def cmd_append(c: FdfsClient, args: list[str]) -> int:
    """fdfs_append_file: append a local file to an appender file."""
    if len(args) < 2:
        print("usage: append <tracker> <appender_file_id> <local_file>",
              file=sys.stderr)
        return 2
    with open(args[1], "rb") as fh:
        c.append_buffer(args[0], fh.read())
    print("appended")
    return 0


def cmd_upload_appender(c: FdfsClient, args: list[str]) -> int:
    """fdfs_upload_appender: create an appender file."""
    if not args:
        print("usage: upload_appender <tracker> <local_file> [ext]",
              file=sys.stderr)
        return 2
    ext = args[1] if len(args) > 1 else os.path.splitext(args[0])[1].lstrip(".")[:6]
    with open(args[0], "rb") as fh:
        print(c.upload_appender_buffer(fh.read(), ext=ext))
    return 0


def cmd_delete_server(c: FdfsClient, args: list[str]) -> int:
    """fdfs_monitor's delete-server action (non-active members only)."""
    if len(args) < 2:
        print("usage: delete_server <tracker> <group> <ip:port>",
              file=sys.stderr)
        return 2
    ip, _, port = args[1].partition(":")
    c.delete_storage(args[0], ip, int(port))
    print("deleted")
    return 0


def cmd_set_trunk_server(c: FdfsClient, args: list[str]) -> int:
    """fdfs_monitor's set-trunk-server action."""
    if len(args) < 2:
        print("usage: set_trunk_server <tracker> <group> <ip:port>",
              file=sys.stderr)
        return 2
    ip, _, port = args[1].partition(":")
    c.set_trunk_server(args[0], ip, int(port))
    print("trunk server set")
    return 0


def cmd_near_dups(c: FdfsClient, args: list[str]) -> int:
    """Ranked near-duplicates of a stored file from the dedup engine's
    MinHash/LSH index (fastdfs_tpu extension; no reference equivalent —
    the upstream tree has no similarity index at all)."""
    if not args:
        print("usage: near_dups <tracker> <file_id>", file=sys.stderr)
        return 2
    pairs = c.near_dups(args[0])
    if not pairs:
        print("no near-duplicates known")
        return 0
    for fid, score in pairs:
        print(f"{score:.4f}  {fid}")
    return 0


def cmd_tracker_status(c: FdfsClient, args: list[str]) -> int:
    """Multi-tracker relationship probe (leader + role)."""
    print(json.dumps(c.tracker_status()))
    return 0


def cmd_trace(c: FdfsClient, args: list[str]) -> int:
    """Distributed request tracing: run one traced upload through the
    cluster, collect every node's span ring (TRACE_DUMP), stitch by
    trace_id, and render the cross-node timeline.

    Flags: --file <path>     trace an upload of this file (default: a
                             random 256 KB payload, deleted afterwards)
           --size <bytes>    random payload size for the default mode
           --trace-id <hex>  skip the upload; render an existing trace
                             from the cluster's rings
           --wait <s>        settle time before collecting (default 1.5,
                             lets the replication hop record sync spans)
           --json            machine-readable span list instead of the
                             timeline
    """
    import time as _time

    from fastdfs_tpu_torch import trace as T

    def flag(name, default=None):
        return _flag(args, name, default)

    trace_id = None
    cleanup_fid = None
    tracer = None
    if flag("--trace-id") is not None:
        trace_id = int(flag("--trace-id"), 16)
    else:
        if flag("--file") is not None:
            with open(flag("--file"), "rb") as fh:
                data = fh.read()
            ext = os.path.splitext(flag("--file"))[1].lstrip(".")[:6]
        else:
            data = os.urandom(int(flag("--size", "262144")))
            ext = "bin"
            cleanup_fid = True
        fid, tracer = T.traced_upload(c, data, ext=ext)
        trace_id = tracer.trace_id
        print(f"uploaded {fid}  trace_id={trace_id:016x}", file=sys.stderr)
        _time.sleep(float(flag("--wait", "1.5")))  # let replication ship
        if cleanup_fid:
            try:
                c.delete_file(fid)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass
    spans, errors = T.collect_cluster_spans(c)
    if tracer is not None:  # merge the client-side spans recorded locally
        spans.extend(tracer.spans)
    matched = [s for s in spans if s.trace_id == trace_id]
    for node, err in errors.items():
        print(f"warning: {node}: {err}", file=sys.stderr)
    if "--json" in args:
        print(T.spans_to_json(matched))
    else:
        print(T.render_timeline(matched, trace_id))
    return 0 if matched else 1


def cmd_profile(c: FdfsClient, args: list[str]) -> int:
    """One-shot CPU profile of a daemon (fdfs_profile): arm the
    in-daemon SIGPROF sampler, wait out the capture window, pull the
    folded-stack dump, and print it — collapsed-stack text by default
    (pipe straight into flamegraph.pl or load into speedscope), raw
    dump JSON with --json.

    Usage: profile <tracker> <ip:port> [--tracker] [flags]

           <ip:port>      the daemon to profile (a storage node, or
                          with --tracker a tracker)
           --hz N         sample rate (default 97 — prime, so it can't
                          alias against 10ms timer wheels; clamped to
                          the daemon's profile_max_hz)
           --seconds N    capture window (default 5; the daemon
                          auto-disarms at the deadline either way)
           --folded       collapsed-stack output (the default)
           --json         raw PROFILE_DUMP JSON instead
           --no-wait      arm and exit (dump later with --dump-only)
           --dump-only    skip arming; dump whatever the last capture
                          holds
           --stop         disarm early and exit

    ENOTSUP (status 95) means profiling is off at the daemon: set
    profile_max_hz > 0 in its conf (see OPERATIONS.md "Profiling & the
    thread ledger" — the feature costs nothing until armed).
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M
    from fastdfs_tpu_torch.client.tracker_client import TrackerClient

    def flag(name, default=None):
        return _flag(args, name, default)

    node = next((a for a in args if not a.startswith("--")
                 and ":" in a), None)
    if node is None:
        print("usage: profile <tracker> <ip:port> [--tracker] [--hz N] "
              "[--seconds N] [--folded|--json] [--stop]", file=sys.stderr)
        return 2
    ip, _, port_s = node.rpartition(":")
    port = int(port_s)
    hz = int(flag("--hz", "97"))
    seconds = int(flag("--seconds", "5"))
    is_tracker = "--tracker" in args

    def ctl(what, *a):
        if is_tracker:
            with TrackerClient(ip, port, c.timeout) as t:
                return getattr(t, what)(*a)
        return getattr(c, f"storage_{what}")(ip, port, *a)

    if "--stop" in args:
        print(json.dumps(ctl("profile_stop"), sort_keys=True))
        return 0
    if "--dump-only" not in args:
        ack = ctl("profile_start", hz, seconds)
        print(f"armed {node} at {ack.get('hz', hz)} Hz for {seconds}s",
              file=sys.stderr)
        if "--no-wait" in args:
            return 0
        # The daemon disarms itself at the deadline; the slack covers
        # the last in-flight SIGPROF and tick jitter.
        _time.sleep(seconds + 0.5)
    raw = ctl("profile_dump")
    dump = M.decode_profile(raw)
    if dump.dropped:
        print(f"warning: {dump.dropped} samples dropped (slab full) — "
              "the busiest window is under-represented", file=sys.stderr)
    if "--json" in args:
        print(json.dumps(raw, sort_keys=True))
    else:
        print(M.render_folded(dump))
    return 0


def cmd_scrub(c: FdfsClient, args: list[str]) -> int:
    """Integrity engine (anti-entropy) console: per-storage scrub status
    from the SCRUB_STATUS blob, with optional kick and watch modes.

    Flags: --kick          force a verify+repair+GC pass on every
                           storage first (SCRUB_KICK)
           --watch [s]     re-render every s seconds (default 2) until
                           interrupted
           --group <name>  limit to one group
           --json          machine-readable {addr: {field: value}}
    """
    import time as _time

    group = None
    if "--group" in args:
        i = args.index("--group")
        if i + 1 >= len(args) or args[i + 1].startswith("--"):
            print("usage: scrub <tracker> [--kick] [--watch [s]] "
                  "[--group <name>] [--json]", file=sys.stderr)
            return 2
        group = args[i + 1]
    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass

    def storages():
        cs = c.cluster_stat(group)
        return [(s["ip"], s["port"])
                for g in cs.get("groups", [])
                for s in g.get("storages", [])]

    members = storages()
    if not members:
        print("no storages known to the tracker", file=sys.stderr)
        return 1
    if "--kick" in args:
        for ip, port in members:
            try:
                c.scrub_kick(ip, port)
                print(f"kicked {ip}:{port}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — keep kicking the rest
                print(f"kick {ip}:{port} failed: {e}", file=sys.stderr)

    def render_once() -> int:
        rows: dict[str, dict] = {}
        errors: dict[str, str] = {}
        for ip, port in members:
            addr = f"{ip}:{port}"
            try:
                rows[addr] = c.scrub_status(ip, port)
            except Exception as e:  # noqa: BLE001 — a dead node is a row
                errors[addr] = str(e)
        if "--json" in args:
            # Unreachable nodes appear as {"error": ...} entries, and any
            # error makes the exit code nonzero — a monitoring consumer
            # must never mistake a partial answer for a healthy cluster.
            merged: dict[str, dict] = dict(rows)
            merged.update({a: {"error": e} for a, e in errors.items()})
            print(json.dumps(merged, indent=2, sort_keys=True))
        else:
            for addr, st in sorted(rows.items()):
                state = "RUNNING" if st["running"] else "idle"
                print(f"{addr}  {state}  passes={st['passes']} "
                      f"progress={st['pass_chunks_done']}"
                      f"/{st['pass_chunks_total']}")
                print(f"  verified: {st['chunks_verified']} chunks "
                      f"({st['bytes_verified']} bytes)   corrupt: "
                      f"{st['chunks_corrupt']}  repaired: "
                      f"{st['chunks_repaired']}  unrepairable: "
                      f"{st['corrupt_unrepairable']}  quarantined: "
                      f"{st['quarantined']}")
                print(f"  gc: pending {st['gc_pending_chunks']} chunks "
                      f"({st['gc_pending_bytes']} bytes)   reclaimed "
                      f"{st['chunks_reclaimed']} chunks + "
                      f"{st['recipes_reclaimed']} recipes "
                      f"({st['bytes_reclaimed']} bytes)")
            for addr, err in sorted(errors.items()):
                print(f"{addr}  error: {err}")
        return 0 if rows and not errors else 1

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- scrub @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_ec(c: FdfsClient, args: list[str]) -> int:
    """Erasure-coding cold-tier console: per-storage EC status from the
    EC_STATUS blob — stripe inventory, demotion/release accounting, and
    reconstruction counters — with optional kick and watch modes.

    Flags: --kick          force an EC demotion pass on every storage
                           first (EC_KICK: age gate dropped to 0 for
                           one pass, then the scrubber is kicked)
           --watch [s]     re-render every s seconds (default 2) until
                           interrupted
           --group <name>  limit to one group
           --json          machine-readable {addr: {field: value}}

    Daemons with EC off (ec_k = 0, nothing striped on disk) answer
    StatusError(95) and render as "ec off" rows rather than errors.
    """
    import time as _time

    group = None
    if "--group" in args:
        i = args.index("--group")
        if i + 1 >= len(args) or args[i + 1].startswith("--"):
            print("usage: ec <tracker> [--kick] [--watch [s]] "
                  "[--group <name>] [--json]", file=sys.stderr)
            return 2
        group = args[i + 1]
    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass

    def storages():
        cs = c.cluster_stat(group)
        return [(s["ip"], s["port"])
                for g in cs.get("groups", [])
                for s in g.get("storages", [])]

    members = storages()
    if not members:
        print("no storages known to the tracker", file=sys.stderr)
        return 1
    if "--kick" in args:
        for ip, port in members:
            try:
                c.ec_kick(ip, port)
                print(f"kicked {ip}:{port}", file=sys.stderr)
            except StatusError as e:
                if e.status == 95:  # EC off here — not a failure
                    print(f"skip {ip}:{port}: ec off", file=sys.stderr)
                else:
                    print(f"kick {ip}:{port} failed: {e}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — keep kicking the rest
                print(f"kick {ip}:{port} failed: {e}", file=sys.stderr)

    def render_once() -> int:
        rows: dict[str, dict] = {}
        off: list[str] = []
        errors: dict[str, str] = {}
        for ip, port in members:
            addr = f"{ip}:{port}"
            try:
                rows[addr] = c.ec_status(ip, port)
            except StatusError as e:
                if e.status == 95:
                    off.append(addr)
                else:
                    errors[addr] = str(e)
            except Exception as e:  # noqa: BLE001 — a dead node is a row
                errors[addr] = str(e)
        if "--json" in args:
            merged: dict[str, dict] = dict(rows)
            merged.update({a: {"enabled": 0} for a in off})
            merged.update({a: {"error": e} for a, e in errors.items()})
            print(json.dumps(merged, indent=2, sort_keys=True))
        else:
            for addr, st in sorted(rows.items()):
                scheme = (f"RS({st['k']}+{st['m']})" if st["enabled"]
                          else "draining")
                print(f"{addr}  {scheme}  stripes={st['stripes']} "
                      f"chunks={st['stripe_chunks']} "
                      f"data={st['data_bytes']}B "
                      f"parity={st['parity_bytes']}B")
                print(f"  demoted: {st['demoted_chunks']} chunks "
                      f"({st['demoted_bytes']} bytes)   released: "
                      f"{st['released_chunks']} chunks "
                      f"({st['released_bytes']} bytes)   remote reads: "
                      f"{st['remote_reads']}")
                print(f"  reconstructed: {st['reconstructed_shards']} "
                      f"shards ({st['reconstructed_bytes']} bytes)   "
                      f"repair fallbacks: {st['repair_fallback_chunks']}"
                      f"   last demote: {st['last_demote_unix']}")
            for addr in sorted(off):
                print(f"{addr}  ec off")
            for addr, err in sorted(errors.items()):
                print(f"{addr}  error: {err}")
        return 0 if not errors else 1

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- ec @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_health(c: FdfsClient, args: list[str]) -> int:
    """Gray-failure health console: the tracker's N x N differential
    matrix (HEALTH_MATRIX — each node's self-reported score against what
    its group peers score it, with the tracker's verdict) and, with
    --detail, every storage's own HEALTH_STATUS table (per-peer, per-op
    EWMA latency / error% / timeout%, disk-probe latencies, stalled
    threads).

    Verdicts: ok      both views at/above the gray threshold
              gray    peers score it below threshold while its own
                      trailer claims healthy — the signature gray
                      failure (slow disk, flaky NIC, wedged thread)
              sick    its own trailer admits a score below threshold
              unknown no health data yet (old storage, or just booted)

    Flags: --detail        also query each storage's HEALTH_STATUS
           --watch [s]     re-render every s seconds (default 2) until
                           interrupted
           --json          machine-readable {matrix: ..., status: ...}
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass

    def render_once() -> int:
        raw = c.health_matrix()
        matrix = M.decode_health_matrix(raw)
        detail: dict[str, dict] = {}
        errors: dict[str, str] = {}
        if "--detail" in args:
            for n in matrix.nodes:
                ip, _, port = n.addr.rpartition(":")
                try:
                    detail[n.addr] = c.storage_health_status(ip, int(port))
                except Exception as e:  # noqa: BLE001 — a dead node is a row
                    errors[n.addr] = str(e)
        if "--json" in args:
            print(json.dumps({"matrix": raw, "status": detail,
                              "errors": errors}, indent=2, sort_keys=True))
            return 0 if not errors else 1
        print(f"gray threshold: {matrix.gray_threshold}  "
              f"(score 0..100, 100 = healthy)")
        cols = (f"{'node':<28} {'verdict':<8} {'self':>5} {'peers':>6} "
                f"{'reports':>7} {'age':>5}")
        print(cols)
        print("-" * len(cols))
        order = {"gray": 0, "sick": 1, "unknown": 2, "ok": 3}
        flagged = 0
        for n in sorted(matrix.nodes,
                        key=lambda n: (order[n.verdict], n.addr)):
            if n.verdict in ("gray", "sick"):
                flagged += 1
            self_s = "-" if n.self_score < 0 else str(n.self_score)
            peer_s = "-" if n.peer_avg < 0 else str(n.peer_avg)
            age = "-" if n.age_s < 0 else f"{n.age_s}s"
            print(f"{n.group + '/' + n.addr:<28} {n.verdict:<8} "
                  f"{self_s:>5} {peer_s:>6} {n.reports:>7} {age:>5}")
        for addr, raw_st in sorted(detail.items()):
            st = M.decode_health_status(raw_st)
            print(f"\n{addr}  self={st.score}  stalled={st.stalled_threads}"
                  f"  probe read={st.probe_read_us}us "
                  f"write={st.probe_write_us}us "
                  f"(threshold {st.probe_threshold_ms}ms)")
            for p in st.peers:
                print(f"  {p.addr:<24} {p.op:<6} score={p.score:<4} "
                      f"ewma={p.rpc_ewma_us}us err={p.error_pct}% "
                      f"timeout={p.timeout_pct}% "
                      f"ops={p.ops}/{p.errors}e/{p.timeouts}t "
                      f"age={p.age_s}s")
        for addr, err in sorted(errors.items()):
            print(f"\n{addr}  error: {err}")
        return 0 if not errors else 1

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- health @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_admission(c: FdfsClient, args: list[str]) -> int:
    """Overload-control console: every daemon's admission-ladder status
    (ADMISSION_STATUS) — the tracker's plus each storage's shed level,
    pressure EWMA against its tighten/relax thresholds, and lifetime
    per-class shed counts.  The status opcode is born control-class, so
    it answers even from a daemon at reads-only.

    Flags: --watch [s]     re-render every s seconds (default 2) until
                           interrupted
           --json          machine-readable {addr: {field: value}}
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass

    def storages():
        cs = c.cluster_stat()
        return [(s["ip"], s["port"])
                for g in cs.get("groups", [])
                for s in g.get("storages", [])]

    members = storages()

    def render_once() -> int:
        rows: dict[str, dict] = {}
        errors: dict[str, str] = {}
        try:
            raw = c.tracker_admission_status()
            rows[f"tracker {raw['port']}"] = raw
        except Exception as e:  # noqa: BLE001 — a dead node is a row
            errors["tracker"] = str(e)
        for ip, port in members:
            addr = f"{ip}:{port}"
            try:
                rows[addr] = c.storage_admission_status(ip, port)
            except Exception as e:  # noqa: BLE001
                errors[addr] = str(e)
        if "--json" in args:
            merged: dict[str, dict] = dict(rows)
            merged.update({a: {"error": e} for a, e in errors.items()})
            print(json.dumps(merged, indent=2, sort_keys=True))
            return 0 if rows and not errors else 1
        cols = (f"{'node':<24} {'level':<16} {'ewma':>6} {'thresh':>11} "
                f"{'admitted':>9} {'shed':>7} {'retry':>7}")
        print(cols)
        print("-" * len(cols))
        for addr, raw_st in sorted(rows.items()):
            st = M.decode_admission(raw_st)
            off = "" if st.enabled else " (DISABLED)"
            thresh = f"{st.relax_threshold}/{st.tighten_threshold}"
            print(f"{addr:<24} {st.level_name:<16} {st.ewma:>6.2f} "
                  f"{thresh:>11} {st.admitted:>9} {st.shed:>7} "
                  f"{st.retry_after_ms:>5}ms{off}")
            shed = {k: v for k, v in sorted(st.shed_by_class.items())
                    if v}
            if shed:
                print("  shed by class: " +
                      "  ".join(f"{k}={v}" for k, v in shed.items()))
        for addr, err in sorted(errors.items()):
            print(f"{addr}  error: {err}")
        return 0 if rows and not errors else 1

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- admission @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_hot(c: FdfsClient, args: list[str]) -> int:
    """Elastic hot-replication console: the tracker's
    published hot map (QUERY_HOT_MAP — every promoted file and the
    extra groups serving it), the tracker's promotion/demotion ledger
    gauges, each storage's fan-out progress gauges, and a per-node
    hot-file pane straight from the heat sketches (the same table
    fdfs_top --heat renders).

    Flags: --watch [s]     re-render every s seconds (default 2) until
                           interrupted
           --rows N        heat-pane rows per node (default 5)
           --json          machine-readable {map: ..., tracker: ...,
                           storages: ..., heat: ...}
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass
    rows = int(_flag(args, "--rows", "5") or 5)

    _TRACKER_GAUGES = ("hot.map_version", "hot.promoted", "hot.pending",
                       "hot.retiring", "hot.promotions_total",
                       "hot.demotions_total", "hot.tracked_keys")
    _STORAGE_GAUGES = ("hot.fanout_replicated", "hot.fanout_dropped",
                       "hot.fanout_verify_failures", "hot.fanout_failures",
                       "hot.fanout_queue")

    def members():
        cs = c.cluster_stat()
        return [(s["ip"], s["port"])
                for g in cs.get("groups", [])
                for s in g.get("storages", [])]

    def render_once() -> int:
        hot_map = c.query_hot_map()
        tracker_gauges: dict[str, int] = {}
        try:
            reg = c._with_tracker(lambda t: t.stat())
            tracker_gauges = {k: v for k, v in reg.get("gauges", {}).items()
                              if k in _TRACKER_GAUGES}
        except Exception as e:  # noqa: BLE001 — gauges are best-effort
            print(f"warning: tracker stat: {e}", file=sys.stderr)
        storages: dict[str, dict] = {}
        heat: dict[str, list] = {}
        for ip, port in members():
            addr = f"{ip}:{port}"
            try:
                reg = c.storage_stat(ip, port)
                storages[addr] = {k: v
                                  for k, v in reg.get("gauges", {}).items()
                                  if k in _STORAGE_GAUGES}
            except Exception as e:  # noqa: BLE001 — a dead node is a row
                storages[addr] = {"error": str(e)}
            try:
                heat[addr] = M.decode_heat(c.storage_heat_top(ip, port,
                                                              rows))
            except Exception:  # noqa: BLE001 — heat off / old node
                heat[addr] = []
        if "--json" in args:
            print(json.dumps({
                "map": hot_map,
                "tracker": tracker_gauges,
                "storages": storages,
                "heat": {n: [vars(h) for h in hs]
                         for n, hs in heat.items()},
            }, indent=2, sort_keys=True))
            return 0
        print(f"hot map v{hot_map['version']} "
              f"({len(hot_map['entries'])} published):")
        if not hot_map["entries"]:
            print("  (none)")
        for e in hot_map["entries"]:
            print(f"  {e['key']} -> {','.join(e['groups'])}")
        if tracker_gauges:
            print("tracker: " +
                  "  ".join(f"{k.removeprefix('hot.')}={v}"
                            for k, v in sorted(tracker_gauges.items())))
        print("fan-out (per elected storage):")
        for addr, st in sorted(storages.items()):
            if "error" in st:
                print(f"  {addr}  error: {st['error']}")
                continue
            print(f"  {addr}  " +
                  "  ".join(f"{k.removeprefix('hot.fanout_')}={v}"
                            for k, v in sorted(st.items())))
        print(f"hot files (top {rows} per node, "
              "hits / err-bound / MB / ops):")
        for line in M._heat_table_lines(heat, rows):
            print(line)
        return 0

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- hot @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_group(c: FdfsClient, args: list[str]) -> int:
    """Group lifecycle console (multi-group scale-out): the placement
    epoch with per-group state and, for draining groups, each member's
    rebalance progress from its last beat.

    Forms: group <tracker> status [--json] [--watch [s]]
           group <tracker> drain <name>
           group <tracker> reactivate <name>
    """
    import time as _time

    from fastdfs_tpu_torch import monitor as M

    usage = ("usage: group <tracker> status [--json] [--watch [s]] | "
             "drain <name> | reactivate <name>")
    if not args:
        print(usage, file=sys.stderr)
        return 2
    verb = args[0]

    if verb in ("drain", "reactivate"):
        if len(args) < 2 or args[1].startswith("--"):
            print(usage, file=sys.stderr)
            return 2
        name = args[1]
        fn = c.group_drain if verb == "drain" else c.group_reactivate
        version = fn(name)
        print(f"group {name} {verb} accepted: placement version {version}")
        return 0
    if verb != "status":
        print(usage, file=sys.stderr)
        return 2

    interval = 0.0
    if "--watch" in args:
        i = args.index("--watch")
        interval = 2.0
        if i + 1 < len(args) and not args[i + 1].startswith("--"):
            try:
                interval = float(args[i + 1])
            except ValueError:
                pass

    _REB = ("rebalance_files_moved", "rebalance_bytes_moved",
            "rebalance_files_pending", "rebalance_errors", "rebalance_done")

    def render_once() -> int:
        table = c.query_placement()
        # Rebalance progress rides the beat: pull each member's last-beat
        # stat slots out of the tracker's cluster dump (one RPC).
        beats: dict[str, dict] = {}
        try:
            cs = c.cluster_stat()
            for g in cs.get("groups", []):
                for s in g.get("storages", []):
                    beats[f"{s['ip']}:{s['port']}"] = \
                        M.beat_stats_from_storage(s)
        except Exception as e:  # noqa: BLE001 — progress is best-effort
            print(f"warning: cluster_stat: {e}", file=sys.stderr)
        if "--json" in args:
            out = {"version": table["version"], "groups": []}
            for g in table["groups"]:
                row = dict(g)
                row["rebalance"] = {
                    f"{m['ip']}:{m['port']}": {
                        k: beats.get(f"{m['ip']}:{m['port']}", {}).get(k, 0)
                        for k in _REB}
                    for m in g["members"]}
                out["groups"].append(row)
            print(json.dumps(out, indent=2, sort_keys=True))
            return 0
        print(f"placement version {table['version']}  "
              f"({len(table['groups'])} groups)")
        for g in table["groups"]:
            print(f"{g['group']:<16} {g['state_name']:<9} "
                  f"members={len(g['members'])}")
            for m in g["members"]:
                addr = f"{m['ip']}:{m['port']}"
                b = beats.get(addr)
                if b is None or g["state_name"] == "active":
                    continue
                done = "yes" if b.get("rebalance_done", 0) else "no"
                print(f"  {addr}  moved={b.get('rebalance_files_moved', 0)} "
                      f"({b.get('rebalance_bytes_moved', 0)} bytes)  "
                      f"pending={b.get('rebalance_files_pending', 0)}  "
                      f"errors={b.get('rebalance_errors', 0)}  done={done}")
        return 0

    if interval <= 0:
        return render_once()
    try:
        while True:
            if "--json" not in args:  # keep --watch --json parseable
                print(f"-- groups @ {_time.strftime('%H:%M:%S')} --")
            render_once()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


TOOLS = {
    "upload": cmd_upload,
    "download": cmd_download,
    "delete": cmd_delete,
    "file_info": cmd_file_info,
    "monitor": cmd_monitor,
    "top": cmd_top,
    "report": cmd_report,
    "test": cmd_test,
    "groups_json": cmd_groups_json,
    "append": cmd_append,
    "upload_appender": cmd_upload_appender,
    "delete_server": cmd_delete_server,
    "set_trunk_server": cmd_set_trunk_server,
    "tracker_status": cmd_tracker_status,
    "near_dups": cmd_near_dups,
    "trace": cmd_trace,
    "profile": cmd_profile,
    "scrub": cmd_scrub,
    "ec": cmd_ec,
    "health": cmd_health,
    "admission": cmd_admission,
    "group": cmd_group,
    "hot": cmd_hot,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    if argv[:1] == ["--device"] and len(argv) > 1:
        device, argv = argv[1], argv[2:]
    if len(argv) < 2 or argv[0] not in TOOLS:
        print("usage: python -m fastdfs_tpu_torch.cli [--device cuda|cpu] "
              f"<{'|'.join(TOOLS)}> <client.conf|tracker_host:port> "
              "[args...]", file=sys.stderr)
        return 2
    # Outside the CLI's catch-all: a card asked for and missing raises.
    dev = resolve_device(device)
    tool, conf = argv[0], argv[1]
    try:
        return TOOLS[tool](_client(conf, dev), argv[2:])
    except Exception as e:  # CLI surface: print, nonzero exit
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
