"""Binary wire protocol: header framing, opcodes, field widths.

The port's copy of ``fastdfs_tpu/common/protocol.py``: the 10-byte header
(8-byte big-endian body length, 1-byte command, 1-byte status), the full
``TrackerCmd`` and ``StorageCmd`` opcode tables, and the field codecs the
client, the sidecar and ``trace.py`` use.  The reference module stays the
contract: the C++ daemons in ``native/`` generate their opcode table from
it (``native/gen_protocol.py``), and tests hold this copy equal to it,
member for member and byte for byte.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Field widths (reference: common/fdfs_proto.h constants)
# ---------------------------------------------------------------------------

GROUP_NAME_MAX_LEN = 16          # FDFS_GROUP_NAME_MAX_LEN
IP_ADDRESS_SIZE = 16             # IP_ADDRESS_SIZE (dotted-quad + NUL)
FILE_EXT_NAME_MAX_LEN = 6        # FDFS_FILE_EXT_NAME_MAX_LEN
FILE_PREFIX_MAX_LEN = 16         # FDFS_FILE_PREFIX_MAX_LEN (slave names)
FILENAME_BASE64_LENGTH = 27      # FDFS_FILENAME_BASE64_LENGTH (20 raw bytes)
STORAGE_ID_MAX_SIZE = 16
PROTO_PKG_LEN_SIZE = 8
MAX_META_NAME_LEN = 64
MAX_META_VALUE_LEN = 256

# Metadata wire separators (reference: fdfs_proto.h FDFS_RECORD_SEPARATOR /
# FDFS_FIELD_SEPARATOR).
RECORD_SEPARATOR = b"\x01"
FIELD_SEPARATOR = b"\x02"

HEADER_SIZE = PROTO_PKG_LEN_SIZE + 2  # 8B len + 1B cmd + 1B status

# ---------------------------------------------------------------------------
# Storage-beat stat blob (reference: FDFSStorageStat in tracker_types.h,
# shipped to the tracker on every TRACKER_PROTO_CMD_STORAGE_BEAT).
#
# The beat body carries BEAT_STAT_COUNT big-endian int64 slots after the
# identity prefix; slot i is named BEAT_STAT_FIELDS[i].  The C++ daemons
# compile against the generated mirror (protocol_gen.h kBeatStatNames),
# so the tracker's JSON stat feed and the Python monitor agree on every
# field by construction.  Slots 0-18 are the storage's restart-persisted
# op counters (storage_stat.dat); 19+ are live values sampled at beat
# time.  Append-only: new fields go at the end (the tracker accepts
# shorter blobs from older storages, missing slots read 0).
# ---------------------------------------------------------------------------

BEAT_STAT_FIELDS = (
    "total_upload", "success_upload",
    "total_download", "success_download",
    "total_delete", "success_delete",
    "total_append", "success_append",
    "total_set_meta", "success_set_meta",
    "total_get_meta", "success_get_meta",
    "total_query", "success_query",
    "bytes_uploaded", "bytes_downloaded",
    "dedup_hits", "dedup_bytes_saved",
    "last_source_update",
    "connections",
    "refused_connections",
    "sync_lag_s",
    "sync_bytes_saved_wire",
    "recovery_chunks_fetched",
    "recovery_chunks_local",
    "recovery_files",
    "fetch_chunk_batches",
    "dedup_chunk_misses",
    "rebalance_files_moved",
    "rebalance_bytes_moved",
    "rebalance_files_pending",
    "rebalance_errors",
    "rebalance_done",
)
BEAT_STAT_COUNT = len(BEAT_STAT_FIELDS)

# ---------------------------------------------------------------------------
# Integrity-engine status blob (fastdfs_tpu extension; no reference
# equivalent — upstream FastDFS never re-reads stored bytes).
#
# The ``StorageCmd.SCRUB_STATUS`` response body carries SCRUB_STAT_COUNT
# big-endian int64 slots; slot i is named SCRUB_STAT_FIELDS[i].  The C++
# daemon compiles against the generated mirror (protocol_gen.h
# kScrubStatNames), and the layout is pinned by the ``fdfs_codec
# scrub-status`` cross-language golden.  Append-only like the beat blob:
# new fields go at the end, decoders read missing tail slots as 0.
# ---------------------------------------------------------------------------

SCRUB_STAT_FIELDS = (
    "running",               # a verify/GC pass is in flight right now
    "passes",                # completed passes since start
    "pass_chunks_done",      # progress within the current pass
    "pass_chunks_total",
    "chunks_verified",       # cumulative re-hashed chunks
    "bytes_verified",
    "chunks_corrupt",        # digest mismatches found (incl. truncations)
    "chunks_repaired",       # quarantined chunks restored from a replica
    "corrupt_unrepairable",  # repair attempts with no replica serving it
    "quarantined",           # currently quarantined (live refs, bytes aside)
    "skipped_pinned",        # corrupt but pinned by an in-flight stream
    "gc_pending_chunks",     # zero-ref chunks inside the grace window
    "gc_pending_bytes",
    "chunks_reclaimed",      # zero-ref chunks unlinked by GC sweeps
    "bytes_reclaimed",       # chunk + recipe-sidecar bytes reclaimed
    "recipes_reclaimed",     # recipe sidecar files deleted with their file
    "last_pass_unix",
    "last_pass_duration_us",
)
SCRUB_STAT_COUNT = len(SCRUB_STAT_FIELDS)


def pack_scrub_stats(stats: dict[str, int]) -> bytes:
    """SCRUB_STATUS response body from named values (tests/goldens; the
    production encoder is the C++ daemon)."""
    return b"".join(long2buff(int(stats.get(name, 0)))
                    for name in SCRUB_STAT_FIELDS)


def unpack_scrub_stats(buf: bytes) -> dict[str, int]:
    """Name a SCRUB_STATUS blob; missing tail slots read 0 (the wire
    contract is append-only, so an older daemon's shorter blob decodes)."""
    n = len(buf) // 8
    vals = [buff2long(buf, i * 8) for i in range(min(n, SCRUB_STAT_COUNT))]
    vals += [0] * (SCRUB_STAT_COUNT - len(vals))
    return dict(zip(SCRUB_STAT_FIELDS, vals))


# ---------------------------------------------------------------------------
# Erasure-coding status blob (fastdfs_tpu extension; no reference
# equivalent — upstream FastDFS only replicates).
#
# The ``StorageCmd.EC_STATUS`` response body carries EC_STAT_COUNT
# big-endian int64 slots; slot i is named EC_STAT_FIELDS[i].  The C++
# daemon compiles against the generated mirror (protocol_gen.h
# kEcStatNames), and the layout is pinned by the ``fdfs_codec
# ec-status`` cross-language golden.  Append-only like the beat and
# scrub blobs: new fields go at the end, decoders read missing tail
# slots as 0.
# ---------------------------------------------------------------------------

EC_STAT_FIELDS = (
    "enabled",                 # ec_k > 0 on this daemon
    "k",                       # data shards per stripe
    "m",                       # parity shards per stripe
    "stripes",                 # live stripes in this node's EC store
    "stripe_chunks",           # live chunks resident in those stripes
    "data_bytes",              # logical chunk bytes inside live stripes
    "parity_bytes",            # parity + padding overhead bytes on disk
    "demoted_chunks",          # cumulative chunks encoded into stripes
    "demoted_bytes",
    "released_chunks",         # replica copies dropped after EC handover
    "released_bytes",
    "reconstructed_shards",    # shards rebuilt from parity by scrub
    "reconstructed_bytes",
    "repair_fallback_chunks",  # stripes past parity, refilled via FETCH_CHUNK
    "remote_reads",            # released-chunk reads served via a peer fetch
    "last_demote_unix",
)
EC_STAT_COUNT = len(EC_STAT_FIELDS)


def pack_ec_stats(stats: dict[str, int]) -> bytes:
    """EC_STATUS response body from named values (tests/goldens; the
    production encoder is the C++ daemon)."""
    return b"".join(long2buff(int(stats.get(name, 0)))
                    for name in EC_STAT_FIELDS)


def unpack_ec_stats(buf: bytes) -> dict[str, int]:
    """Name an EC_STATUS blob; missing tail slots read 0 (append-only
    wire contract, same discipline as the scrub blob)."""
    n = len(buf) // 8
    vals = [buff2long(buf, i * 8) for i in range(min(n, EC_STAT_COUNT))]
    vals += [0] * (EC_STAT_COUNT - len(vals))
    return dict(zip(EC_STAT_FIELDS, vals))


PROFILE_CTL_LEN = 17


def pack_profile_ctl(start: bool, hz: int = 0, duration_s: int = 0) -> bytes:
    """PROFILE_CTL request body: 1B action (1 = start, 0 = stop) + 8B BE
    hz + 8B BE duration seconds.  Stop ignores the numbers but still
    carries the full 17-byte shape (fixed-size bodies keep the daemon's
    recv path branch-free; pinned by the fdfs_codec profile-ctl golden)."""
    return bytes([1 if start else 0]) + long2buff(hz) + long2buff(duration_s)

# Largest request body a daemon will buffer in memory (larger bodies
# stream to disk, or the connection is closed).  A WIRE contract, not a
# tuning knob: senders of inline-only commands (e.g. the chunk-aware
# replication query) must size against it or their requests are
# unparseable at the peer.
MAX_INLINE_BODY = 64 << 20

# ---------------------------------------------------------------------------
# Trace context (fastdfs_tpu extension; no reference equivalent).
#
# A traced request is prefixed by one TRACE_CTX frame: a normal 10-byte
# header with cmd=TRACE_CTX and pkg_len=TRACE_CTX_LEN, whose body is the
# 16-byte context (8B trace_id + 4B parent span_id + 4B flags, all
# big-endian).  The frame elicits NO response; the daemon stashes the
# context on the connection and applies it to the NEXT request, whose
# spans then stitch cross-node by trace_id.  Append-only wire contract:
# an untraced request is byte-identical to the pre-trace protocol, so
# old daemons and old clients interoperate untraced.
# ---------------------------------------------------------------------------

TRACE_CTX_LEN = 16
TRACE_FLAG_SAMPLED = 1      # context carried an explicit client sample
TRACE_FLAG_SLOW = 2         # span force-retained by the slow-request gate

_TRACE_CTX_STRUCT = struct.Struct(">QII")


def pack_trace_ctx(trace_id: int, span_id: int, flags: int = TRACE_FLAG_SAMPLED) -> bytes:
    """16-byte TRACE_CTX frame body (big-endian, like every wire int)."""
    return _TRACE_CTX_STRUCT.pack(trace_id & (2**64 - 1),
                                  span_id & (2**32 - 1),
                                  flags & (2**32 - 1))


def unpack_trace_ctx(buf: bytes) -> tuple[int, int, int]:
    """(trace_id, parent_span_id, flags) from a TRACE_CTX frame body."""
    if len(buf) < TRACE_CTX_LEN:
        raise ValueError(f"short trace ctx: {len(buf)} < {TRACE_CTX_LEN}")
    return _TRACE_CTX_STRUCT.unpack_from(buf)

# ---------------------------------------------------------------------------
# Request QoS / admission control (fastdfs_tpu extension; no reference
# equivalent — upstream FastDFS queues past saturation unboundedly).
#
# Every request has a priority class.  A tagged request is prefixed by
# one PRIORITY frame: a normal 10-byte header with cmd=PRIORITY and
# pkg_len=PRIORITY_FRAME_LEN whose body is the single class byte.  Like
# TRACE_CTX the frame elicits NO response; the daemon stashes the class
# on the connection and applies it to the NEXT request.  Untagged
# requests default by opcode class (DefaultPriorityClass below —
# scrub/rebalance/sync traffic is born BACKGROUND), so an un-upgraded
# client is byte-identical to the pre-QoS protocol and still gets sane
# shedding behavior.
#
# The admission ladder (native/storage/admission.h AdmissionController):
#   level 0  admit everything
#   level 1  shed BACKGROUND
#   level 2  shed BULK + BACKGROUND
#   level 3  shed everything but CONTROL + INTERACTIVE (reads)
# i.e. a class is admitted at level L iff  class + L <= 4.  A shed
# request is answered EBUSY with an 8-byte big-endian retry-after hint
# in milliseconds as the response body; the client backs off (with
# jitter) instead of hammering a saturated daemon.
# ---------------------------------------------------------------------------

PRIORITY_FRAME_LEN = 1


class PriorityClass(enum.IntEnum):
    """Request priority classes, best (never shed) first."""

    CONTROL = 0      # stats/health/admin plane — how operators see in
    INTERACTIVE = 1  # client reads: downloads, metadata, file info
    NORMAL = 2       # client writes: uploads, appends, deletes
    BULK = 3         # negotiated bulk ingest (recipe/chunk uploads)
    BACKGROUND = 4   # replication, recovery fetches, EC release


def admitted_at_level(priority_class: int, level: int) -> bool:
    """The ladder contract: class c is admitted at level L iff c + L <= 4
    (level 0 admits all; level 3 admits only control + reads).  Mirrors
    AdmissionController::Admit — pinned by the fdfs_codec
    admission-ladder golden."""
    return level <= 0 or priority_class + level <= PriorityClass.BACKGROUND


def pack_priority(priority_class: int) -> bytes:
    """1-byte PRIORITY frame body."""
    if not 0 <= priority_class <= 0xFF:
        raise ValueError(f"bad priority class: {priority_class}")
    return bytes([priority_class])


def unpack_priority(buf: bytes) -> int:
    if len(buf) < PRIORITY_FRAME_LEN:
        raise ValueError("short priority frame")
    return buf[0]


def priority_frame(priority_class: int) -> bytes:
    """The full prefix frame (header + class byte) sent before a tagged
    request; elicits no response."""
    return pack_header(PRIORITY_FRAME_LEN, StorageCmd.PRIORITY) \
        + pack_priority(priority_class)


def pack_retry_after(retry_after_ms: int) -> bytes:
    """EBUSY shed-response body: the daemon's backoff hint."""
    return long2buff(int(retry_after_ms))


def unpack_retry_after(buf: bytes) -> int:
    """Retry-after ms from an EBUSY body; 0 when the body carries none
    (older daemons and non-admission EBUSYs answer status-only)."""
    if len(buf) < 8:
        return 0
    return max(buff2long(buf), 0)


# Untagged requests default by opcode (the C++ mirror is
# DefaultPriorityClass in native/storage/admission.cc; the two tables
# are pinned against each other by the fdfs_codec priority-frame
# golden).  Keyed by raw cmd value; anything unlisted is NORMAL.
_STORAGE_PRIORITY_DEFAULTS: dict[int, int] = {}


def default_priority_class(cmd: int) -> int:
    """Born-priority of an untagged storage-port request."""
    if not _STORAGE_PRIORITY_DEFAULTS:
        S, P = StorageCmd, PriorityClass
        for c in (S.STAT, S.TRACE_DUMP, S.EVENT_DUMP, S.METRICS_HISTORY,
                  S.HEAT_TOP, S.SCRUB_STATUS, S.SCRUB_KICK, S.EC_STATUS,
                  S.EC_KICK, S.HEALTH_STATUS, S.ADMISSION_STATUS,
                  S.PROFILE_CTL, S.PROFILE_DUMP, S.ACTIVE_TEST,
                  S.QUERY_FILE_INFO):
            _STORAGE_PRIORITY_DEFAULTS[int(c)] = int(P.CONTROL)
        for c in (S.DOWNLOAD_FILE, S.GET_METADATA, S.NEAR_DUPS):
            _STORAGE_PRIORITY_DEFAULTS[int(c)] = int(P.INTERACTIVE)
        for c in (S.UPLOAD_RECIPE, S.UPLOAD_CHUNKS):
            _STORAGE_PRIORITY_DEFAULTS[int(c)] = int(P.BULK)
        for c in (S.SYNC_CREATE_FILE, S.SYNC_DELETE_FILE,
                  S.SYNC_UPDATE_FILE, S.SYNC_CREATE_LINK,
                  S.SYNC_APPEND_FILE, S.SYNC_MODIFY_FILE,
                  S.SYNC_TRUNCATE_FILE, S.SYNC_QUERY_CHUNKS,
                  S.SYNC_CREATE_RECIPE, S.FETCH_ONE_PATH_BINLOG,
                  S.FETCH_RECIPE, S.FETCH_CHUNK, S.EC_RELEASE):
            _STORAGE_PRIORITY_DEFAULTS[int(c)] = int(P.BACKGROUND)
    return _STORAGE_PRIORITY_DEFAULTS.get(int(cmd), int(PriorityClass.NORMAL))


_HEADER_STRUCT = struct.Struct(">qBB")


class TrackerCmd(enum.IntEnum):
    """Tracker-port opcodes (reference: fdfs_proto.h TRACKER_PROTO_CMD_*)."""

    # storage -> tracker (cluster management)
    STORAGE_JOIN = 81
    QUIT = 82
    STORAGE_BEAT = 83
    STORAGE_REPORT_DISK_USAGE = 84
    STORAGE_REPLICA_CHG = 85
    STORAGE_SYNC_SRC_REQ = 86
    STORAGE_SYNC_DEST_REQ = 87
    STORAGE_SYNC_NOTIFY = 88
    STORAGE_SYNC_REPORT = 89
    STORAGE_SYNC_DEST_QUERY = 79
    STORAGE_REPORT_IP_CHANGED = 78
    STORAGE_CHANGELOG_REQ = 77
    STORAGE_PARAMETER_REQ = 76

    # client -> tracker (ops / listing)
    SERVER_LIST_ONE_GROUP = 90
    SERVER_LIST_ALL_GROUPS = 91
    SERVER_LIST_STORAGE = 92
    SERVER_DELETE_STORAGE = 93
    SERVER_SET_TRUNK_SERVER = 94
    # fastdfs_tpu extension: one-RPC cluster observability dump — tracker
    # role/leader plus every group and storage with the full named
    # last-beat stat payload (JSON body; optional 16B group filter).
    # Upstream's fdfs_monitor stitches this from LIST_ALL_GROUPS +
    # LIST_STORAGE binary structs instead.
    SERVER_CLUSTER_STAT = 95
    # fastdfs_tpu extension: dump the tracker's span ring buffer (empty
    # body -> JSON; shape per fastdfs_tpu.trace.decode_dump, covered by
    # the fdfs_codec trace-json cross-language golden).
    TRACE_DUMP = 96
    # fastdfs_tpu extension: the tracker's own stats-registry snapshot
    # (empty body -> the same {"counters","gauges","histograms"} JSON
    # contract as StorageCmd.STAT) — event-loop lag, dispatched ops,
    # request accounting.  `fdfs_top` polls this for the tracker row.
    STAT = 97
    # fastdfs_tpu extension: flight-recorder dump (empty body -> JSON
    # {"role","port","events":[...]}; shape per
    # fastdfs_tpu.monitor.decode_events, pinned by the fdfs_codec
    # event-json cross-language golden).
    EVENT_DUMP = 98
    # fastdfs_tpu extension: metrics-journal window dump (the tracker's
    # durable telemetry history; native/common/metrog.h).  Body = empty
    # or 8B BE since-ts (epoch µs; 0 = everything retained) -> JSON
    # {"role","port","snapshots":[{"ts_us",counters,gauges,histograms}]}
    # per fastdfs_tpu.monitor.decode_metrics_history; pinned by the
    # fdfs_codec metrics-history cross-language golden.  ENOTSUP when
    # journaling is off (metrics_journal_mb = 0).  Same contract as
    # StorageCmd.METRICS_HISTORY.
    METRICS_HISTORY = 99

    # client -> tracker (service queries; reference: tracker_deal_service_query_*)
    SERVICE_QUERY_STORE_WITHOUT_GROUP_ONE = 101
    SERVICE_QUERY_FETCH_ONE = 102
    SERVICE_QUERY_UPDATE = 103
    SERVICE_QUERY_STORE_WITH_GROUP_ONE = 104
    SERVICE_QUERY_FETCH_ALL = 105
    SERVICE_QUERY_STORE_WITHOUT_GROUP_ALL = 106
    SERVICE_QUERY_STORE_WITH_GROUP_ALL = 107

    RESP = 100
    ACTIVE_TEST = 111

    # tracker <-> tracker (leader election; reference: tracker_relationship.c)
    TRACKER_GET_STATUS = 70
    TRACKER_GET_SYS_FILES_START = 61
    TRACKER_GET_SYS_FILES_END = 62
    TRACKER_GET_ONE_SYS_FILE = 63
    TRACKER_PING_LEADER = 71
    TRACKER_NOTIFY_NEXT_LEADER = 72
    TRACKER_COMMIT_NEXT_LEADER = 73
    # fastdfs_tpu extension: followers fetch the per-group trunk-server
    # decision from the elected tracker leader instead of electing locally
    # (upstream: only the leader calls tracker_mem_find_trunk_server).
    TRACKER_GET_TRUNK_SERVER = 74

    # fastdfs_tpu extension: consistent-placement epoch fetch (the
    # store_lookup = 3 subsystem; arXiv:1406.2294 jump hash over the
    # ordered group list).  Empty request body -> response = 8B BE
    # placement version + 8B BE entry count + per entry (16B group name +
    # 1B state [0 active / 1 draining / 2 retired] + 8B BE member count +
    # per member (16B ip + 8B BE port)), members being the group's ACTIVE
    # storages.  Clients cache the table and compute
    # jump_hash(sha1(key)[:8], n_active) locally to route uploads without
    # a tracker round-trip; any routing failure or EBUSY refresh-and-
    # falls-back to the classic QUERY_STORE path.  Entry order is the
    # epoch contract: groups append on first join and NEVER reorder, so
    # adding group N+1 remaps only ~1/(N+1) of keys.  Followers serve
    # their last table adopted from the leader.  Pinned by the fdfs_codec
    # placement-wire cross-language golden.
    QUERY_PLACEMENT = 64
    # fastdfs_tpu extension: group lifecycle admin (leader-only; EBUSY
    # from a follower, like SERVER_SET_TRUNK_SERVER).  Request body =
    # 16B group name; OK response body = 8B BE new placement version.
    # DRAIN moves active -> draining (no new writes placed there; reads
    # and replication continue; storages start the paced rebalance
    # migrator), REACTIVATE moves draining -> active.  Idempotent; ENOENT
    # for an unknown group.  Pinned by the fdfs_codec group-admin
    # cross-language golden.
    GROUP_DRAIN = 65
    GROUP_REACTIVATE = 66
    # fastdfs_tpu extension: in-daemon sampling profiler + thread ledger
    # (OPERATIONS.md "Profiling & the thread ledger").  CTL body = 1B
    # action (1 = start, 0 = stop) + 8B BE hz + 8B BE duration seconds
    # (stop ignores the numbers; the 17-byte shape is pinned by the
    # fdfs_codec profile-ctl cross-language golden).  Start is
    # idempotent (re-arming restarts the capture window) and the daemon
    # auto-stops at the duration so a vanished client cannot leave the
    # timer armed.  ENOTSUP unless profile_max_hz > 0.  NOTE: the design
    # doc assigned the tracker 100/101, but 100 is RESP and 101 is
    # SERVICE_QUERY_STORE_WITHOUT_GROUP_ONE (both upstream-fixed), so
    # the tracker pair lives at 67/68 next to the other fastdfs_tpu
    # admin extensions; the storage pair keeps its planned 141/142.
    PROFILE_CTL = 67
    # Folded-stack dump: empty body -> JSON per
    # fastdfs_tpu.monitor.decode_profile (pinned by the fdfs_codec
    # profile-json golden).  ENOTSUP while a capture was never started.
    PROFILE_DUMP = 68
    # fastdfs_tpu extension: N x N differential gray-failure matrix
    # (OPERATIONS.md "Health, probes & gray failure").  Every storage
    # appends a health trailer to its beat (self gray score + its EWMA
    # scores ABOUT each group peer, append-only past the pinned stat
    # slots); the tracker folds those into per-node rows so a node most
    # *peers* report slow is flagged gray even while it self-reports
    # healthy.  Empty body -> JSON {"role","port","gray_threshold",
    # "nodes":[{"group","addr","self","peer_avg","reports","verdict",
    # "age_s","peers":{addr:score}}]} with verdict one of ok | gray |
    # sick | unknown.  Shape per fastdfs_tpu.monitor.decode_health_matrix;
    # pinned by the fdfs_codec health-matrix cross-language golden.
    HEALTH_MATRIX = 69

    # fastdfs_tpu extension: the elastic hot-replication map
    # (OPERATIONS.md "Elastic hot replication").  The tracker leader's
    # heat policy merges the per-node heat trailers riding each storage
    # beat (append-only past the health trailer: 1B version=2 + 8B BE
    # entry count + per entry (8B BE key_len + key + 8B BE cumulative
    # read hits + 8B BE cumulative read bytes)), promotes file-ids whose
    # windowed cluster-wide read EWMA crosses hot_promote_threshold to
    # extra replica groups, and serves the epoch-versioned map here.
    # Request body = empty (full map) or 8B BE since_version (delta).
    # Response = 8B BE map version + 1B full flag (1 = full snapshot;
    # 0 = delta relative to the requested since_version) + 8B BE entry
    # count + per entry (8B BE key_len + key + 8B BE extra-group count +
    # per group 16B group name).  A delta entry with ZERO extra groups is
    # a tombstone: the key was demoted — drop it from the cache.  Full
    # snapshots carry only live (published) entries.  Clients route hot
    # reads across home + extra replicas by
    # jump_hash(sha1("<file_id>#<range_index>")[:8], n_replicas) — the
    # established cache-affinity pick — and fall back to the classic
    # tracker path on any failure.  Pinned by the fdfs_codec hot-map
    # cross-language golden.
    QUERY_HOT_MAP = 75
    # fastdfs_tpu extension: storage -> tracker ack completing a hot
    # fan-out task (the tracker tasks the home group's elected member
    # via a beat-response trailer; the member pushes + byte-verifies,
    # then acks here, and ONLY then does the tracker publish the map
    # entry — verify-then-publish, so a routed read can never miss).
    # Body = 16B home group + 1B task type (1 = replicate, 2 = drop) +
    # 8B BE key_len + key + 8B BE verified-group count + per group 16B
    # group name.  OK response body = empty.  Pinned by the fdfs_codec
    # hot-map cross-language golden.
    HOT_FANOUT_DONE = 80

    # fastdfs_tpu extension: distributed-tracing context prefix frame
    # (see TRACE_CTX_LEN above).  Deliberately the SAME value on both
    # ports (StorageCmd.TRACE_CTX) so framing code is shared.
    TRACE_CTX = 140
    # fastdfs_tpu extension: request-priority prefix frame (see
    # PRIORITY_FRAME_LEN above).  Same value on both ports
    # (StorageCmd.PRIORITY) so framing code is shared.  On the tracker
    # the class gates the EXPENSIVE observability dumps (cluster stat,
    # metrics history, trace/event/profile dumps are born BULK) while
    # beats, joins, and service queries stay CONTROL — a lagging
    # single-loop tracker sheds dashboards before it sheds the cluster.
    PRIORITY = 147
    # fastdfs_tpu extension: admission-controller snapshot.  Empty body
    # -> JSON {"role","port","enabled","level","level_name","pressure",
    # "ewma","tighten_threshold","relax_threshold","tightens","relaxes",
    # "retry_after_ms","admitted","shed","shed_by_class":{...}} per
    # fastdfs_tpu.monitor.decode_admission; pinned by the fdfs_codec
    # admission-json cross-language golden.  Same contract as
    # StorageCmd.ADMISSION_STATUS.
    ADMISSION_STATUS = 148


class StorageCmd(enum.IntEnum):
    """Storage-port opcodes (reference: fdfs_proto.h STORAGE_PROTO_CMD_*)."""

    UPLOAD_FILE = 11
    DELETE_FILE = 12
    SET_METADATA = 13
    DOWNLOAD_FILE = 14
    GET_METADATA = 15
    SYNC_CREATE_FILE = 16
    SYNC_DELETE_FILE = 17
    SYNC_UPDATE_FILE = 18
    SYNC_CREATE_LINK = 19
    CREATE_LINK = 20
    UPLOAD_SLAVE_FILE = 21
    QUERY_FILE_INFO = 22
    UPLOAD_APPENDER_FILE = 23
    APPEND_FILE = 24
    SYNC_APPEND_FILE = 25
    FETCH_ONE_PATH_BINLOG = 26

    # trunk subsystem (reference: storage/trunk_mgr/).  Opcodes 30-33
    # (upstream's trunk_sync.c binlog-shipping protocol) are deliberately
    # ABSENT: this rebuild replicates trunk slot writes through the main
    # binlog (op 'c'/'d' with trunk file-IDs, tests/test_trunk.py), so a
    # second replication channel would be dead surface.  The values stay
    # reserved for wire compatibility.
    TRUNK_ALLOC_SPACE = 27
    TRUNK_ALLOC_CONFIRM = 28
    TRUNK_FREE_SPACE = 29

    MODIFY_FILE = 34
    SYNC_MODIFY_FILE = 35
    TRUNCATE_FILE = 36
    SYNC_TRUNCATE_FILE = 37

    # fastdfs_tpu extension: dedup-engine sidecar RPCs (no reference
    # equivalent; carried on the same framing so the C++ daemons reuse one
    # codec).  Values chosen clear of the upstream table — later upstream
    # releases keep assigning the 38+ range (e.g. 38 becomes
    # REGENERATE_APPENDER_FILENAME), so ALL extensions live at 120+.
    DEDUP_FINGERPRINT = 120
    DEDUP_QUERY = 121
    DEDUP_COMMIT = 122
    DEDUP_NEARDUPS = 123
    # Like DEDUP_FINGERPRINT, but the caller already ran CDC (the C++
    # daemon's AVX2 gear chunker — same table, identical cut points) and
    # ships the cut offsets with the bytes: body = 8B session + 8B
    # base_offset + 8B n_cuts + n_cuts x 8B relative exclusive ends +
    # raw segment.  The engine then skips its own chunking pass — on a
    # host-limited link that halves the bytes the accelerator round-trip
    # has to move (CDC is branchy scalar work the CPU does at GB/s; the
    # hashing is the FLOP-heavy part that belongs on the TPU).
    DEDUP_FINGERPRINT_CUTS = 125

    # Chunk-aware replication (fastdfs_tpu extension; the reference ships
    # every logical byte for every replica, storage_sync.c).  A sender
    # whose file is stored as a recipe first asks the peer which chunks
    # it lacks, then ships the recipe plus ONLY the missing chunk bytes:
    #   SYNC_QUERY_CHUNKS: 16B group + 8B name_len + name + N x 20B raw
    #     digests -> response body N bytes (0 = present, 1 = needed);
    #     ENOTSUP when the peer has no chunk store (sender falls back to
    #     the full-copy SYNC_CREATE_FILE).
    #   SYNC_CREATE_RECIPE: 16B group + 8B name_len + 8B logical_size +
    #     8B chunk_count + 8B payload_len + name + per chunk (20B digest
    #     + 8B length + 1B needed) + concatenated needed chunk payloads.
    SYNC_QUERY_CHUNKS = 126
    SYNC_CREATE_RECIPE = 127

    # Chunk-aware disk recovery (fastdfs_tpu extension): the rebuilding
    # node PULLS recipes and only the chunk bytes its store lacks,
    # instead of re-downloading every logical byte (the reference's
    # storage_disk_recovery.c fetches full files).
    #   FETCH_RECIPE: 16B group + remote name -> 8B logical_size + 8B
    #     chunk_count + per chunk (20B raw digest + 8B length); ENOENT
    #     when the file is stored flat (caller downloads normally).
    #   FETCH_CHUNK: 16B group + 8B name_len + name + 8B count +
    #     count x (20B raw digest + 8B expect_len) -> the payloads
    #     concatenated in request order (lengths are known from the
    #     recipe).  BATCHED so a rebuild pays one round-trip per ~8 MB
    #     of missing bytes, not one per ~8 KB chunk.  ENOENT when any
    #     requested chunk is gone (caller falls back to a full download
    #     of that file).
    FETCH_RECIPE = 128
    FETCH_CHUNK = 129
    # Stats dump (fastdfs_tpu extension): empty body -> JSON snapshot of
    # the daemon's stats registry (per-opcode counters and latency
    # histograms, dedup hits/misses and bytes-saved-on-wire, per-peer
    # binlog sync lag, recovery chunk accounting).  The shape is the
    # registry contract: {"counters":{},"gauges":{},"histograms":{}} —
    # decoded by fastdfs_tpu.monitor and covered by a cross-language
    # golden test.
    STAT = 130
    # Span ring-buffer dump (fastdfs_tpu extension): empty body -> JSON
    # {"role","port","spans":[...]} per fastdfs_tpu.trace.decode_dump
    # (cross-language golden: fdfs_codec trace-json).
    TRACE_DUMP = 131
    # Dedup-aware negotiated upload (fastdfs_tpu extension; no reference
    # equivalent — upstream ships every byte of every upload).  The
    # client chunks + fingerprints locally (the same gear CDC + SHA1 the
    # daemons run, so cut points agree cluster-wide) and only ships
    # chunk bytes the storage's content-addressed ChunkStore lacks:
    #   UPLOAD_RECIPE: 1B store_path_index (0xFF = server picks) + 6B
    #     ext + 8B crc32 + 8B logical_size + 8B chunk_count + per chunk
    #     (20B raw digest + 8B length) -> response 8B session_id +
    #     chunk_count bytes (0 = present, 1 = needed), with the present
    #     chunks PINNED server-side (PinRecipe discipline) until the
    #     session commits, aborts, or times out.  ENOTSUP when the
    #     daemon has no chunk store (client falls back to UPLOAD_FILE;
    #     an OLDER daemon answers the unknown opcode with EINVAL, which
    #     the client treats the same way).
    #   UPLOAD_CHUNKS: 8B session_id + 8B payload_len + the needed
    #     chunks' payloads concatenated in recipe order.  The daemon
    #     verifies SHA1(payload) == digest per chunk (the replication
    #     receiver's check), assembles the file via PutAndRef + refs +
    #     recipe write, logs the binlog record, and answers exactly
    #     like UPLOAD_FILE (16B group + remote filename).  ENOENT when
    #     the session is unknown/expired (client falls back to a plain
    #     upload).
    UPLOAD_RECIPE = 132
    UPLOAD_CHUNKS = 133
    # Integrity engine (fastdfs_tpu extension; see native/storage/scrub.*).
    #   SCRUB_STATUS: empty body -> SCRUB_STAT_COUNT big-endian int64
    #     slots named by SCRUB_STAT_FIELDS (append-only; cross-language
    #     golden: fdfs_codec scrub-status).  ENOTSUP when the daemon has
    #     no chunk store (dedup off — nothing to scrub).
    #   SCRUB_KICK: empty body -> status 0 once a verify+GC pass has been
    #     scheduled (runs even when scrub_interval_s = 0, so operators
    #     and tests can drive passes deterministically).
    SCRUB_STATUS = 134
    SCRUB_KICK = 135
    # Sidecar RPC: batched chunk-integrity verify on the accelerator
    # (ops/sha1.sha1_batch) for the storage scrubber.  Body = 8B count +
    # count x (8B length + 20B expected raw SHA1) + the payloads
    # concatenated; response = count bytes (0 = digest matches,
    # 1 = mismatch).  The daemon falls back to its serial host SHA1 when
    # the sidecar is unreachable — scrubbing never blocks on the TPU.
    DEDUP_VERIFY = 136
    # Flight-recorder dump (fastdfs_tpu extension): empty body -> JSON
    # {"role","port","events":[{"seq","ts_us","severity","type","key",
    # "detail"}]} — the daemon's bounded ring of structured cluster
    # events (chunk quarantined/repaired/healed, GC sweeps, upload-
    # session expiry, dedup fallbacks, replication stalls, slow
    # requests, config anomalies).  Shape per
    # fastdfs_tpu.monitor.decode_events; pinned by the fdfs_codec
    # event-json cross-language golden.  Same contract as
    # TrackerCmd.EVENT_DUMP.
    EVENT_DUMP = 137
    # Metrics-journal window dump (fastdfs_tpu extension; see
    # native/common/metrog.h): every daemon appends a delta-encoded,
    # CRC-framed snapshot of its stats registry to a size-capped on-disk
    # ring each SLO tick, so rate/quantile time-series survive a crash
    # or restart.  Body = empty or 8B BE since-ts (epoch µs; 0 = all
    # retained history) -> JSON {"role","port","snapshots":[{"ts_us",
    # "counters","gauges","histograms"}]} — each snapshot is the full
    # absolute registry view (the on-disk delta encoding is a storage
    # detail, never on the wire).  Shape per
    # fastdfs_tpu.monitor.decode_metrics_history; pinned by the
    # fdfs_codec metrics-history cross-language golden.  ENOTSUP when
    # journaling is off (metrics_journal_mb = 0).
    METRICS_HISTORY = 138
    # Hot-key heat telemetry (fastdfs_tpu extension; see
    # native/common/heatsketch.h): a lock-striped space-saving top-K
    # sketch fed from the request-accounting choke point, keyed by
    # file-id for DOWNLOAD_FILE / uploads / FETCH_CHUNK, with per-op
    # request and byte counts.  Body = empty or 8B BE k (0 = the
    # daemon's heat_top_k default) -> JSON {"role","port","k","tracked",
    # "touches","entries":[{"key","hits","err_bound","bytes","ops":
    # {"download":{"count","bytes"},...}}]} sorted by hits descending.
    # Shape per fastdfs_tpu.monitor.decode_heat; pinned by the
    # fdfs_codec heat-top cross-language golden.  ENOTSUP when the
    # sketch is off (heat_top_k = 0).
    HEAT_TOP = 139
    # Trace-context prefix frame (same value as TrackerCmd.TRACE_CTX).
    TRACE_CTX = 140
    # Ranked near-dup report for a stored file, answered from the
    # sidecar's MinHash/LSH index.  Body = 16B group + remote filename;
    # response = text lines "<file_id> <score>".  ENOTSUP when the dedup
    # mode has no near index.
    NEAR_DUPS = 124
    # Sampling profiler + thread ledger, same contract as the tracker
    # pair (TrackerCmd.PROFILE_CTL / PROFILE_DUMP — CTL semantics and
    # body shape documented there; both pinned by the profile-ctl /
    # profile-json cross-language goldens).
    PROFILE_CTL = 141
    PROFILE_DUMP = 142
    # Erasure-coded cold tier (fastdfs_tpu extension; see
    # native/storage/ecstore.*).  Cold chunks past ec_demote_age_s are
    # encoded into RS(k+m) stripes by scrub stage 5, then the replicated
    # copies are released group-wide via a verify-then-release handover.
    #   EC_STATUS: empty body -> EC_STAT_COUNT big-endian int64 slots
    #     named by EC_STAT_FIELDS (append-only; cross-language golden:
    #     fdfs_codec ec-status).  ENOTSUP when EC is off (ec_k = 0) or
    #     the daemon has no chunk store.
    #   EC_KICK: empty body -> status 0 once an EC demote sweep has been
    #     scheduled with the next scrub pass (runs even when
    #     scrub_interval_s = 0, so operators and tests can drive
    #     demotion deterministically).  ENOTSUP when ec_k = 0.
    #   EC_RELEASE: the stripe owner tells a replica peer that a batch
    #     of chunk digests is now parity-protected on the owner, so the
    #     peer may drop its replicated payload bytes (refs and recipe
    #     metadata are retained; reads re-fetch via FETCH_CHUNK).  Body
    #     = 16B group + 8B BE count + count x (20B raw digest + 8B BE
    #     length); response = count bytes (0 = released, 1 = kept —
    #     e.g. pinned by an in-flight upload session or unknown here).
    #     Sent only AFTER the owner verified the stripe decodes
    #     byte-identical (rebalance.map discipline: release.map is
    #     fsynced before the first peer sees the batch).  Pinned by the
    #     fdfs_codec ec-stripe-layout cross-language golden alongside
    #     the on-disk stripe framing it protects.
    EC_STATUS = 143
    EC_KICK = 144
    EC_RELEASE = 145
    # Gray-failure health snapshot (fastdfs_tpu extension; see
    # native/common/healthmon.*).  The daemon's local view: the per-peer
    # EWMA RPC health table (fed passively from every outbound NetRpc
    # plus an active ACTIVE_TEST probe loop), the per-store-path disk
    # probe latencies, and the thread-watchdog state.  Empty body ->
    # JSON {"role","port","score","stalled_threads","probe":
    # {"read_us","write_us","threshold_ms"},"peers":[{"addr","op",
    # "score","rpc_ewma_us","error_pct","timeout_pct","ops","errors",
    # "timeouts","age_s"}]}.  Shape per
    # fastdfs_tpu.monitor.decode_health_status; pinned by the fdfs_codec
    # health-status cross-language golden.
    HEALTH_STATUS = 146
    # Request-priority prefix frame (same value as TrackerCmd.PRIORITY;
    # body = the single class byte, no response — see the admission
    # section above).  The class applies to the NEXT request on the
    # connection; untagged requests default by opcode
    # (default_priority_class), so sync/recovery/EC traffic is born
    # BACKGROUND and shed first when the admission ladder tightens.
    PRIORITY = 147
    # Admission-controller snapshot (contract documented on
    # TrackerCmd.ADMISSION_STATUS; pinned by the fdfs_codec
    # admission-json cross-language golden).  Always answers, even
    # while shedding — it is CONTROL class by construction.
    ADMISSION_STATUS = 148

    RESP = 100
    ACTIVE_TEST = 111


# ---------------------------------------------------------------------------
# Wire-contract annotations, consumed by native/gen_protocol.py when it
# emits native/protocol_manifest.json (the machine-readable contract
# tools/fdfs_lint.py checks the tree against).
#
# NO_WIRE_BODY names opcodes whose request AND response bodies are empty
# or pure status — nothing to pin with a golden.  Every other opcode
# carries a structured body; WIRE_GOLDENS maps those covered by an
# `fdfs_codec <name>` cross-language golden fixture.  An opcode with a
# wire body and no golden must be allowlisted (with a reason) in
# tools/fdfs_lint.py's golden-coverage check — adding an opcode without
# deciding its golden story fails the linter by design.
# ---------------------------------------------------------------------------

NO_WIRE_BODY = frozenset({
    "TrackerCmd.QUIT",            # empty body, no response
    "TrackerCmd.RESP",            # pseudo-opcode: the response header itself
    "TrackerCmd.ACTIVE_TEST",     # empty ping, status-only answer
    "StorageCmd.RESP",
    "StorageCmd.ACTIVE_TEST",
    "StorageCmd.EC_KICK",         # empty body, status-only answer
})

WIRE_GOLDENS = {
    "TrackerCmd.SERVER_CLUSTER_STAT": "stats-json",  # embeds beat-stat names
    "TrackerCmd.TRACE_DUMP": "trace-json",
    "TrackerCmd.STAT": "stats-json",
    "TrackerCmd.EVENT_DUMP": "event-json",
    "TrackerCmd.METRICS_HISTORY": "metrics-history",
    "TrackerCmd.TRACE_CTX": "trace-ctx",
    "StorageCmd.STAT": "stats-json",
    "StorageCmd.TRACE_DUMP": "trace-json",
    "StorageCmd.EVENT_DUMP": "event-json",
    "StorageCmd.METRICS_HISTORY": "metrics-history",
    "StorageCmd.HEAT_TOP": "heat-top",
    "StorageCmd.TRACE_CTX": "trace-ctx",
    "StorageCmd.SCRUB_STATUS": "scrub-status",
    "StorageCmd.UPLOAD_RECIPE": "ingest-wire",
    "StorageCmd.UPLOAD_CHUNKS": "ingest-wire",
    "TrackerCmd.QUERY_PLACEMENT": "placement-wire",
    "TrackerCmd.GROUP_DRAIN": "group-admin",
    "TrackerCmd.GROUP_REACTIVATE": "group-admin",
    "TrackerCmd.PROFILE_CTL": "profile-ctl",
    "TrackerCmd.PROFILE_DUMP": "profile-json",
    "StorageCmd.PROFILE_CTL": "profile-ctl",
    "StorageCmd.PROFILE_DUMP": "profile-json",
    "StorageCmd.EC_STATUS": "ec-status",
    "StorageCmd.EC_RELEASE": "ec-stripe-layout",
    "TrackerCmd.HEALTH_MATRIX": "health-matrix",
    "TrackerCmd.QUERY_HOT_MAP": "hot-map",
    "TrackerCmd.HOT_FANOUT_DONE": "hot-map",
    "StorageCmd.HEALTH_STATUS": "health-status",
    "StorageCmd.PRIORITY": "priority-frame",
    "TrackerCmd.PRIORITY": "priority-frame",
    "StorageCmd.ADMISSION_STATUS": "admission-json",
    "TrackerCmd.ADMISSION_STATUS": "admission-json",
}


class Status(enum.IntEnum):
    """Header status byte: 0 = OK, otherwise an errno-style code."""

    OK = 0
    ENOENT = 2
    EIO = 5
    EBUSY = 16
    EEXIST = 17
    EINVAL = 22
    ENOSPC = 28
    ENODATA = 61
    ENOTSUP = 95
    ECONNREFUSED = 111
    EALREADY = 114


class StorageStatus(enum.IntEnum):
    """Storage-server lifecycle states held by the tracker.

    Reference: ``tracker/tracker_types.h`` FDFS_STORAGE_STATUS_* (values
    flagged "verify" in SURVEY.md §3.4).
    """

    INIT = 0
    WAIT_SYNC = 1
    SYNCING = 2
    IP_CHANGED = 3
    DELETED = 4
    OFFLINE = 5
    ONLINE = 6
    ACTIVE = 7
    RECOVERY = 9
    NONE = 99


class StoreLookup(enum.IntEnum):
    """Upload group-selection policy (reference: tracker.conf store_lookup).

    JUMP_CONSISTENT is a fastdfs_tpu extension (no upstream equivalent):
    uploads place by jump_hash(sha1(client_key)) over the ordered list of
    ACTIVE groups in the placement epoch (TrackerCmd.QUERY_PLACEMENT), so
    adding group N+1 remaps only ~1/(N+1) of keys and draining a group
    has a deterministic re-placement target for every file.
    """

    ROUND_ROBIN = 0
    SPECIFIED_GROUP = 1
    LOAD_BALANCE = 2
    JUMP_CONSISTENT = 3


class StorePathPolicy(enum.IntEnum):
    """Store-path selection inside one server (reference: storage.conf
    store_path_mode? — upstream ``tracker.conf store_path`` 0=rr, 2=load
    balance)."""

    ROUND_ROBIN = 0
    LOAD_BALANCE = 2


class DownloadServer(enum.IntEnum):
    """Replica-selection policy for reads (reference: tracker.conf
    download_server)."""

    ROUND_ROBIN = 0
    SOURCE_FIRST = 1


@dataclass(frozen=True)
class Header:
    """Decoded wire header (reference: fdfs_proto.h TrackerHeader)."""

    pkg_len: int
    cmd: int
    status: int = 0

    def pack(self) -> bytes:
        return _HEADER_STRUCT.pack(self.pkg_len, self.cmd, self.status)


def pack_header(pkg_len: int, cmd: int, status: int = 0) -> bytes:
    """Encode the 10-byte header: int64-BE body length, cmd, status.

    Reference: ``fdfs_proto.c`` fills TrackerHeader via ``long2buff``.
    """
    return _HEADER_STRUCT.pack(pkg_len, cmd, status)


def unpack_header(buf: bytes) -> Header:
    if len(buf) < HEADER_SIZE:
        raise ValueError(f"short header: {len(buf)} < {HEADER_SIZE}")
    pkg_len, cmd, status = _HEADER_STRUCT.unpack_from(buf)
    if pkg_len < 0:
        raise ValueError(f"negative pkg_len {pkg_len}")
    return Header(pkg_len=pkg_len, cmd=cmd, status=status)


def long2buff(n: int) -> bytes:
    """Encode an int64 big-endian (reference: shared_func.c long2buff())."""
    return struct.pack(">q", n)


def buff2long(buf: bytes, offset: int = 0) -> int:
    """Decode a big-endian int64 (reference: shared_func.c buff2long())."""
    return struct.unpack_from(">q", buf, offset)[0]


def pack_group_name(group: str) -> bytes:
    """Fixed-width group-name field: NUL-padded to 16 bytes."""
    raw = group.encode("utf-8")
    if len(raw) > GROUP_NAME_MAX_LEN:
        raise ValueError(f"group name too long: {group!r}")
    return raw.ljust(GROUP_NAME_MAX_LEN, b"\x00")


def unpack_group_name(buf: bytes) -> str:
    return buf[:GROUP_NAME_MAX_LEN].rstrip(b"\x00").decode("utf-8")


def pack_ext_name(ext: str) -> bytes:
    """Fixed-width file-extension field (6 bytes, NUL-padded)."""
    raw = ext.encode("utf-8")
    if len(raw) > FILE_EXT_NAME_MAX_LEN:
        raise ValueError(f"ext name too long: {ext!r}")
    return raw.ljust(FILE_EXT_NAME_MAX_LEN, b"\x00")


def pack_prefix_name(prefix: str) -> bytes:
    """Fixed-width slave-file prefix field (16 bytes, NUL-padded).

    Character rules mirror the C++ codec's IsSlavePrefix (fileid.cc): no
    separators, dots, whitespace, or control bytes — the prefix lands in
    filesystem paths, so reject client-side what the server would refuse.
    """
    raw = prefix.encode("utf-8")
    if not raw or len(raw) > FILE_PREFIX_MAX_LEN or any(
            b <= 0x20 or b == 0x7F or b in b"/." for b in raw):
        raise ValueError(f"bad slave prefix: {prefix!r}")
    return raw.ljust(FILE_PREFIX_MAX_LEN, b"\x00")


def unpack_ext_name(buf: bytes) -> str:
    return buf[:FILE_EXT_NAME_MAX_LEN].rstrip(b"\x00").decode("utf-8")


def pack_metadata(meta: dict[str, str]) -> bytes:
    """Serialize metadata key/values with \\x02 field and \\x01 record
    separators (reference: fdfs_proto.h FDFS_FIELD/RECORD_SEPARATOR,
    client/storage_client.c fdfs_pack_metadata())."""
    if not meta:
        return b""
    recs = []
    for k, v in sorted(meta.items()):
        kb, vb = k.encode("utf-8"), v.encode("utf-8")
        if FIELD_SEPARATOR in kb or RECORD_SEPARATOR in kb:
            raise ValueError(f"metadata key contains separator: {k!r}")
        if FIELD_SEPARATOR in vb or RECORD_SEPARATOR in vb:
            raise ValueError(f"metadata value contains separator: {v!r}")
        recs.append(kb + FIELD_SEPARATOR + vb)
    return RECORD_SEPARATOR.join(recs)


def unpack_metadata(buf: bytes) -> dict[str, str]:
    if not buf:
        return {}
    meta: dict[str, str] = {}
    for rec in buf.split(RECORD_SEPARATOR):
        if not rec:
            continue
        k, _, v = rec.partition(FIELD_SEPARATOR)
        meta[k.decode("utf-8")] = v.decode("utf-8")
    return meta
