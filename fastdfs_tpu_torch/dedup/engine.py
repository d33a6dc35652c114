"""DedupEngine: the upload-path fingerprint pipeline, on a CUDA card.

The port of ``fastdfs_tpu/dedup/engine.py``.  Per ingested byte stream:

    bytes ──CDC (gear, position-parallel)──► chunk spans
          ──one upload: segment + (offset, length) table──► device
          ──SHA-1 kernel + fused sketch kernel, one launch each──►
            digests + signatures, one copy back
          ──exact index──► per-chunk write/skip verdicts
          ──LSH index──► file-level near-duplicate candidates

The kernels read every chunk where it lies in the segment ("ragged"), so
a segment costs one launch of each whatever its chunk lengths.  On a CUDA
device ``_fingerprint_segment`` launches the two hand-written kernels
(``ops.cuda_sha1``, ``ops.cuda_minhash``); on the CPU the same wrappers
take their plain twins, which pad the chunks into ``(row_tile, bucket)``
tiles.  The file-level MinHash signature is the element-wise min over its
chunks' signatures.

With ``fan_out = k`` the segment's chunk table splits into ``k``
contiguous runs balanced by bytes, one per device (the counterpart of the
reference's row sharding over ``parallel.make_fingerprint_step``): each
device gets its run's byte range plus ``SEGMENT_SLACK`` and its run's
table, rebased and ordered longest first, and one launch of each kernel.

Every call of ``fingerprint`` writes its stages to the process's span
ring (``trace.SPAN_RING``): a root ``engine.fingerprint`` and, one after
another from its start to its end, ``engine.cuts`` (the cuts found or
read, and checked), ``engine.stage_wait`` (this thread's previous uploads
landing), ``engine.stage_copy`` (the segment into staging, sliced over a
shared pool of host threads on a card when it is long enough
(``stage_copy``), the slack zeroed), then for each run ``engine.table``
(``_runs`` and the chunk table), ``engine.upload`` (the copies and the event, as enqueued),
``engine.launch`` (the output and both kernels' launches), then
``engine.copy_back`` for each run (which waits on the device) and
``engine.unpack``.  The spans observe; they change no order of work.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from fastdfs_tpu_torch.dedup import stage_copy
from fastdfs_tpu_torch.dedup.index import ExactDigestIndex, MinHashLSHIndex
from fastdfs_tpu_torch.ops import (SEGMENT_SLACK, bucket_lens, chunk_table,
                                   gear_cdc, pack_chunk_table, resolve_device)
from fastdfs_tpu_torch.ops.cuda_minhash import (KERNEL_PERMS,
                                                signature_tiles_cuda,
                                                sketch_ragged_cuda,
                                                survivor_ragged_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_ragged_cuda
from fastdfs_tpu_torch.ops.minhash import (DEFAULT_PERMS, DEFAULT_SHINGLE,
                                           perm_words)
from fastdfs_tpu_torch.ops.sha1 import digest_bytes
from fastdfs_tpu_torch.parallel.mesh import cuda_devices
from fastdfs_tpu_torch.trace import SPAN_RING, CallSpans

_ROOT_SPAN = "engine.fingerprint"
_CUTS = SPAN_RING.code("engine.cuts")
_STAGE_WAIT = SPAN_RING.code("engine.stage_wait")
_STAGE_COPY = SPAN_RING.code("engine.stage_copy")
_TABLE = SPAN_RING.code("engine.table")
_UPLOAD = SPAN_RING.code("engine.upload")
_LAUNCH = SPAN_RING.code("engine.launch")
_COPY_BACK = SPAN_RING.code("engine.copy_back")
_UNPACK = SPAN_RING.code("engine.unpack")


@dataclass(frozen=True)
class DedupConfig:
    min_size: int = gear_cdc.DEFAULT_MIN_SIZE
    avg_bits: int = gear_cdc.DEFAULT_AVG_BITS
    max_size: int = gear_cdc.DEFAULT_MAX_SIZE
    num_perms: int = DEFAULT_PERMS
    shingle: int = DEFAULT_SHINGLE
    lsh_bands: int = 16
    near_dup_threshold: float = 0.5
    near_dup_top_k: int = 5
    # Rows per tile of the plain twins (the CPU path); the CUDA kernels
    # take a segment whole.
    row_tile: int = 256
    # Accepted for field parity with the JAX package's DedupConfig and
    # otherwise ignored: the port routes by device (hand kernels on CUDA,
    # plain twins on the CPU).  False is refused on CUDA, where it would
    # ask for a plain path the port does not run there.
    use_pallas: bool | None = None
    # Cut-selection policy: CDC_POLICY_DEFAULT (frozen, ref-identical) or
    # the opt-in CDC_POLICY_SKIPMIN.  NEVER change on a live index — the
    # policies are distinct content-address namespaces (the sidecar
    # discards snapshots on mismatch, same as a spec bump).
    cdc_policy: int = gear_cdc.CDC_POLICY_DEFAULT
    # Fingerprint fan-out: each segment's chunks split into this many
    # contiguous runs, balanced by bytes, one run per device, one launch of
    # each kernel per run.  None = auto: every visible card on cuda, 1 on
    # the CPU.  row_tile must divide by it.
    fan_out: int | None = None


@dataclass
class ChunkRecord:
    offset: int
    length: int
    digest: bytes          # 20-byte SHA1
    duplicate: bool
    dup_of: object = None  # ref stored at first sight of this digest


@dataclass
class IngestReport:
    file_ref: str
    size: int
    chunks: list[ChunkRecord] = field(default_factory=list)
    file_signature: np.ndarray | None = None
    near_dups: list[tuple[object, float]] = field(default_factory=list)

    @property
    def bytes_total(self) -> int:
        return self.size

    @property
    def bytes_duplicate(self) -> int:
        return sum(c.length for c in self.chunks if c.duplicate)

    @property
    def dedup_ratio(self) -> float:
        return self.bytes_duplicate / self.size if self.size else 0.0


def _bucket_len(n: int, min_size: int, max_size: int) -> int:
    """The reference engine's bucket rule for one length (``bucket_lens``,
    which shapes the plain twins' tiles)."""
    return int(bucket_lens(np.array([n]), min_size, max_size)[0])


def _runs(offsets: np.ndarray, lens: np.ndarray, k: int) -> list[tuple[int, int]]:
    """``k`` contiguous runs ``[a, b)`` of chunk indices, balanced by bytes:
    run ``j`` ends after the last chunk that ends by ``j / k`` of the
    segment.  A run may be empty."""
    ends = offsets + lens
    total = int(ends[-1])
    bounds = np.searchsorted(ends, [total * j // k for j in range(1, k)],
                             side="right")
    edges = [0, *bounds.tolist(), len(lens)]
    return list(zip(edges[:-1], edges[1:]))


class _Staging:
    """This thread's host staging for one segment: its bytes (plus
    SEGMENT_SLACK) and its chunk table (each run's offsets, then its
    lengths and longest-first order as int32 pairs), pinned on a CUDA
    engine and grown to the largest segment seen, the events recorded
    after the last uploads from it, one per device, and the recorder of
    this thread's calls."""

    __slots__ = ("seg", "table", "uploaded", "spans")

    def __init__(self) -> None:
        self.seg = torch.empty(0, dtype=torch.uint8)
        self.table = torch.empty(0, dtype=torch.int64)
        self.uploaded: list[torch.cuda.Event] = []
        self.spans = CallSpans(SPAN_RING, _ROOT_SPAN)


class DedupEngine:
    """Stateful dedup engine: chunk, fingerprint, and judge byte streams.

    One engine per storage process.  Compute (CDC/SHA-1/MinHash) runs on
    ``device`` (``cuda`` unless the caller passes ``cpu``); index mutation
    stays on the host.  The fingerprint kernels run on ``devices``: the
    first ``fan_out`` cards on cuda, ``fan_out`` ranks of the CPU, or a
    list the caller gives (one device may appear more than once).
    """

    def __init__(self, config: DedupConfig | None = None,
                 device: str | torch.device = "cuda",
                 devices: list | None = None) -> None:
        self.config = config or DedupConfig()
        if self.config.cdc_policy not in (gear_cdc.CDC_POLICY_DEFAULT,
                                          gear_cdc.CDC_POLICY_SKIPMIN):
            raise ValueError(f"unknown cdc_policy {self.config.cdc_policy}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.config.use_pallas is False:
            raise ValueError("use_pallas=False: the port has no plain path "
                             "on CUDA; use device='cpu' for the plain twins")
        self.devices = self._fan_devices(devices)
        self.exact = ExactDigestIndex()
        self.near = MinHashLSHIndex(self.config.num_perms, self.config.lsh_bands)
        # The fused sketch kernels sign with 64 permutations, at any
        # shingle width.  Another permutation count runs stages 1-3 in one
        # launch of survivor_ragged_cuda and stage 4 in the stage-4 kernel.
        cfg = self.config
        self._fused = cfg.num_perms == KERNEL_PERMS
        self._consts = {dev: perm_words(cfg.num_perms, dev)
                        for dev in set(self.devices)}
        self._staging = threading.local()
        # How the staging copy ran: calls copied in slices over the shared
        # pool, calls copied inline, and slices the pool's threads copied.
        self.stage_counts = {"stage_sliced": 0, "stage_inline": 0,
                             "stage_pool_slices": 0}
        self._counts_lock = threading.Lock()

    def _fan_devices(self, devices) -> list[torch.device]:
        fan = self.config.fan_out
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
            if len(devs) != (fan or len(devs)) or any(
                    d.type != self.device.type for d in devs):
                raise ValueError(f"devices {devices} are not fan_out {fan} "
                                 f"devices of type {self.device.type}")
        elif self.device.type == "cpu":
            devs = [self.device] * (fan or 1)
        elif fan == 1:
            devs = [self.device]
        else:
            devs = cuda_devices(fan)     # None: every visible card
        if not devs:
            raise ValueError(f"fan_out {fan}: no device")
        if len(devs) > 1 and self.config.row_tile % len(devs):
            raise ValueError(f"row_tile {self.config.row_tile} must divide "
                             f"by fan_out {len(devs)}")
        return devs

    def _thread(self) -> _Staging:
        st = getattr(self._staging, "st", None)
        if st is None:
            st = self._staging.st = _Staging()
        return st

    def _stage(self, st: _Staging, seg_len: int, n: int) -> None:
        """Wait until this thread's previous uploads landed, then grow its
        staging to hold ``seg_len`` bytes plus the slack and an
        ``n``-chunk table."""
        for ev in st.uploaded:
            ev.synchronize()
        st.spans.end(_STAGE_WAIT)
        pinned = self.device.type == "cuda"
        if st.seg.shape[0] < seg_len + SEGMENT_SLACK:
            st.seg = torch.empty(seg_len + SEGMENT_SLACK, dtype=torch.uint8,
                                 pin_memory=pinned)
        if st.table.shape[0] < 2 * n:
            st.table = torch.empty(2 * n, dtype=torch.int64,
                                   pin_memory=pinned)

    def _fingerprint_segment(self, data, offsets: np.ndarray,
                             lens: np.ndarray) -> np.ndarray:
        """One upload of each run's bytes and chunk table to its device,
        one SHA-1 launch and one sketch launch per run, one copy back per
        run, in order: uint32 (N, 5 + P), digests then signatures."""
        n = len(lens)
        seg_len = int(offsets[-1] + lens[-1])
        st = self._thread()
        rec = st.spans
        self._stage(st, seg_len, n)
        host = st.seg.numpy()
        slices, pooled = stage_copy.copy(
            host, np.frombuffer(data, dtype=np.uint8, count=seg_len),
            stage_copy.native_copy(self.device))
        host[seg_len:seg_len + SEGMENT_SLACK] = 0
        with self._counts_lock:
            self.stage_counts["stage_sliced" if slices > 1
                              else "stage_inline"] += 1
            self.stage_counts["stage_pool_slices"] += pooled
        table = st.table.numpy()
        outs = []
        st.uploaded = []
        rec.end(_STAGE_COPY)
        for dev, (a, b) in zip(self.devices,
                               _runs(offsets, lens, len(self.devices))):
            if a == b:
                continue
            # Bytes past the run's end are the next run's or the slack's
            # zeros; the kernels mask everything past a chunk's end.
            lo = int(offsets[a])
            hi = int(offsets[b - 1] + lens[b - 1])
            pack_chunk_table(table[2 * a:2 * b], offsets[a:b] - lo, lens[a:b])
            seg = st.seg[lo:hi + SEGMENT_SLACK]
            tab = st.table[2 * a:2 * b]
            rec.end(_TABLE)
            if dev.type == "cuda":
                seg = seg.to(dev, non_blocking=True)
                tab = tab.to(dev, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                st.uploaded.append(ev)
            rec.end(_UPLOAD)
            outs.append(self._fingerprint_run(dev, seg, *chunk_table(tab, b - a)))
            rec.end(_LAUNCH)
        hosts = []
        for o in outs:
            hosts.append(o.cpu().numpy())
            rec.end(_COPY_BACK)
        return np.concatenate(hosts).view(np.uint32)

    def _fingerprint_run(self, dev, seg, d_off, d_len, d_order
                         ) -> torch.Tensor:
        """One launch of each kernel over one run: int32 (n, 5 + P)."""
        cfg = self.config
        consts = self._consts[dev]
        out = torch.empty((d_off.shape[0], 5 + cfg.num_perms),
                          dtype=torch.int32, device=dev)
        sha1_ragged_cuda(seg, d_off, d_len, d_order, out[:, :5],
                         cfg.row_tile)
        if self._fused:
            sketch_ragged_cuda(seg, d_off, d_len, consts, d_order,
                               out[:, 5:], cfg.row_tile, k=cfg.shingle)
        else:
            z = survivor_ragged_cuda(seg, d_off, d_len, cfg.shingle,
                                     cfg.row_tile, d_order)
            signature_tiles_cuda(z, consts, out[:, 5:], cfg.row_tile)
        return out

    # -- pure compute ------------------------------------------------------

    def fingerprint(self, data: bytes, cuts: list[int] | None = None
                    ) -> tuple[list[tuple[int, int]], np.ndarray, np.ndarray]:
        """Chunk + fingerprint a stream: returns (spans, digests, signatures).

        spans: list of (offset, length).  digests: (N, 5) uint32.
        signatures: (N, P) uint32.  No index state is touched.

        ``cuts`` (exclusive chunk ends) skips the chunking pass when the
        caller already ran an identical CDC (the daemon's native chunker
        shares the gear table).  They must increase and stay within
        ``data``; a chunk may start at any byte.
        """
        rec = self._thread().spans
        rec.open()
        cfg = self.config
        if cuts is None:
            cuts = gear_cdc.chunk_stream(data, cfg.min_size, cfg.avg_bits,
                                         cfg.max_size,
                                         cdc_policy=cfg.cdc_policy,
                                         device=self.device)
        ends = np.asarray(cuts, dtype=np.int64).reshape(-1)
        if not len(ends):
            rec.close(_CUTS)
            return [], np.zeros((0, 5), np.uint32), np.zeros((0, cfg.num_perms), np.uint32)
        lens = np.diff(ends, prepend=0)
        offsets = ends - lens
        if (lens < 0).any() or ends[-1] > len(data) or lens.max() >= 1 << 31:
            raise ValueError("cuts must increase, stay within the data and "
                             "leave chunks under 2 GiB")
        rec.end(_CUTS)
        packed = self._fingerprint_segment(data, offsets, lens)
        out = (list(zip(offsets.tolist(), lens.tolist())),
               np.ascontiguousarray(packed[:, :5]),
               np.ascontiguousarray(packed[:, 5:]))
        rec.close(_UNPACK)
        return out

    def warmup(self) -> None:
        """Load the kernels and run one small segment through them, so the
        first real upload pays no kernel build or first-launch cost.  The
        sidecar calls it before it binds."""
        data = bytes(range(256)) * 2
        self.fingerprint(data, cuts=[1, 7, 70, len(data)])

    # -- stateful ingest ---------------------------------------------------

    def ingest(self, data: bytes, file_ref: str, update_index: bool = True) -> IngestReport:
        """Full upload-path dedup: fingerprint, judge against the indexes,
        optionally commit new digests/signatures to them."""
        report = IngestReport(file_ref=file_ref, size=len(data))
        spans, digests, sigs = self.fingerprint(data)
        if not spans:
            return report

        raw = digest_bytes(digests)
        # Repeats *within* this stream must judge as duplicates even on a
        # dry run, so track first-seen digests locally too.
        seen_here: dict[bytes, list] = {}
        for i, (off, ln) in enumerate(spans):
            dig = raw[i * 20:(i + 1) * 20]
            existing = self.exact.lookup(dig)
            if existing is None:
                existing = seen_here.get(dig)
            if existing is None:
                seen_here[dig] = [file_ref, off]
                if update_index:
                    self.exact.insert(dig, [file_ref, off])
                report.chunks.append(ChunkRecord(off, ln, dig, duplicate=False))
            else:
                report.chunks.append(ChunkRecord(off, ln, dig, duplicate=True,
                                                 dup_of=existing))

        # File-level signature: min over chunk signatures == MinHash of the
        # union of their shingle sets.
        file_sig = sigs.min(axis=0)
        report.file_signature = file_sig
        report.near_dups = [
            (ref, score) for ref, score in self.near.query(
                file_sig, self.config.near_dup_top_k, self.config.near_dup_threshold)
            if ref != file_ref
        ]
        if update_index:
            self.near.add(file_sig, file_ref)
        return report

    # -- persistence -------------------------------------------------------

    def save(self, exact_path: str, near_path: str) -> None:
        self.exact.save(exact_path)
        self.near.save(near_path)

    @classmethod
    def load(cls, exact_path: str, near_path: str,
             config: DedupConfig | None = None,
             device: str | torch.device = "cuda") -> "DedupEngine":
        eng = cls(config, device=device)
        eng.exact = ExactDigestIndex.load(exact_path)
        eng.near = MinHashLSHIndex.load(near_path)
        return eng
