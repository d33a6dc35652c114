"""Digest indexes: exact (SHA1) and near-dup (MinHash + LSH banding).

A copy of ``fastdfs_tpu/dedup/index.py`` (pure NumPy; the reference
module pulls in JAX through its import of ``EMPTY``).  The exact index is
the dedup verdict authority; the LSH index serves near-duplicate queries.
Snapshot formats are byte-compatible with the reference in both
directions: ``SIG_SPEC_VERSION = 2`` signatures and the columnar v2 exact
index.  Beyond the reference: the names of the index's spans in the
process's span ring (``trace.SPAN_RING``), the stages a query writes
into the recorder it is given, and each index's ``counts()``, which the
sidecar's ``stats`` answer carries.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np

from fastdfs_tpu_torch.trace import SPAN_RING

# The sketch's empty-segment sentinel (ops.minhash.EMPTY), kept here so
# the index stays free of torch.
EMPTY = np.uint32(0xFFFFFFFF)

# Bumped whenever the signature spec changes (v2 = the survivor sketch,
# round 3); snapshots carry it so a stale index fails loudly instead of
# silently scoring noise against incompatible signatures.
SIG_SPEC_VERSION = 2


# Sentinel offset meaning "the ref is the carrier object itself, not a
# [carrier, offset] pair" — kept for API generality; production refs are
# always [file_ref, offset].
_OFF_BARE = -(1 << 62)

# Snapshot format version for the exact index (v2 = columnar arrays;
# v1 = flat digest bytes + per-entry json refs).  load() reads both.
_EXACT_SPEC = 2

# The index's spans in the process's span ring, children of the caller's
# call: the sidecar writes the inserts, adds and removals around its
# calls, and ``MinHashLSHIndex.query`` its own stages into the recorder
# it is given (the band lookups; the signature matrix's rebuild, only
# where an add or a compaction dropped it; the scoring).
EXACT_INSERT = SPAN_RING.code("index.exact_insert")
EXACT_REMOVE = SPAN_RING.code("index.exact_remove")
NEAR_ADD = SPAN_RING.code("index.near_add")
NEAR_REMOVE = SPAN_RING.code("index.near_remove")
NEAR_CANDIDATES = SPAN_RING.code("index.near_candidates")
NEAR_STACK = SPAN_RING.code("index.near_stack")
NEAR_SCORE = SPAN_RING.code("index.near_score")


class ExactDigestIndex:
    """digest bytes → ``[carrier, offset]`` ref (chunk locator / file id),
    engineered for tens of millions of entries.

    A plain ``dict[bytes, list]`` costs ~200 B/entry — config 5's nominal
    scale (~62M chunks) would need >12 GB of pure bookkeeping.  Instead:
    an LSM-flavored layout with a sorted ``S20`` digest column plus
    parallel ``int32`` carrier-id / ``int64`` offset columns (the BASE),
    and a small dict DELTA for recent inserts, merged into the base when
    it grows past a quarter of it.  ~36 B/entry steady-state, batch
    lookups vectorize through ``np.searchsorted``, and snapshots are raw
    column dumps (SHA1 digests are incompressible — no zlib pass).

    Carrier objects (file ids) are interned in a side table, so the per
    entry cost is independent of file-id length.  Removals tombstone
    base rows (compacted at the next merge) and delete delta entries.
    """

    def __init__(self) -> None:
        self._base_dig = np.empty(0, dtype="S20")
        self._base_carrier = np.empty(0, dtype=np.int32)
        self._base_off = np.empty(0, dtype=np.int64)
        self._base_dead = np.empty(0, dtype=bool)
        self._dead = 0                                  # tombstoned rows
        self._delta: dict[bytes, tuple[int, int]] = {}  # dig -> (cid, off)
        self._carriers: list[Any] = []
        self._carrier_ids: dict[Any, int] = {}
        self._len = 0
        self.merges = 0                                 # delta folds

    def __len__(self) -> int:
        return self._len

    def counts(self) -> dict[str, int]:
        """The entries waiting in the delta and the merges so far."""
        return {"exact_delta": len(self._delta), "exact_merges": self.merges}

    # -- internals ---------------------------------------------------------

    def _cid(self, carrier: Any) -> int:
        i = self._carrier_ids.get(carrier)
        if i is None:
            i = len(self._carriers)
            self._carriers.append(carrier)
            self._carrier_ids[carrier] = i
        return i

    @staticmethod
    def _decompose(ref: Any) -> tuple[Any, int]:
        if (isinstance(ref, (list, tuple)) and len(ref) == 2
                and isinstance(ref[1], (int, np.integer))):
            return ref[0], int(ref[1])
        return ref, _OFF_BARE

    def _compose(self, cid: int, off: int) -> Any:
        c = self._carriers[cid]
        return c if off == _OFF_BARE else [c, off]

    def _base_row(self, digest: bytes) -> int:
        """Row index of a LIVE base entry, or -1."""
        n = len(self._base_dig)
        if n == 0:
            return -1
        # The probe must be an S20 ARRAY scalar, not np.bytes_: only
        # S20-to-S20 comparison gets NUL-padding semantics, so the ~1/256
        # SHA1 digests ending in 0x00 still match their stored row.
        q = np.array(digest, dtype="S20")
        i = int(np.searchsorted(self._base_dig, q))
        if i < n and self._base_dig[i] == q and not self._base_dead[i]:
            return i
        return -1

    def _merge(self) -> None:
        """Fold the delta into the base (and compact tombstones)."""
        alive = ~self._base_dead if self._dead else slice(None)
        parts_d = [self._base_dig[alive]]
        parts_c = [self._base_carrier[alive]]
        parts_o = [self._base_off[alive]]
        if self._delta:
            nd = len(self._delta)
            parts_d.append(np.fromiter(self._delta.keys(), dtype="S20",
                                       count=nd))
            vals = self._delta.values()
            parts_c.append(np.fromiter((v[0] for v in vals), dtype=np.int32,
                                       count=nd))
            parts_o.append(np.fromiter((v[1] for v in self._delta.values()),
                                       dtype=np.int64, count=nd))
        dig = np.concatenate(parts_d)
        order = np.argsort(dig, kind="stable")
        self._base_dig = dig[order]
        self._base_carrier = np.concatenate(parts_c)[order]
        self._base_off = np.concatenate(parts_o)[order]
        self._base_dead = np.zeros(len(dig), dtype=bool)
        self._dead = 0
        self._delta = {}
        self.merges += 1
        self._compact_carriers()

    def _compact_carriers(self) -> None:
        """Drop forgotten (None-slotted) carriers and remap the base
        carrier column — without this, create/forget churn leaks every
        dead file-id string into RAM and every snapshot forever.  Only
        runs on merge, when the delta is empty (its cids would otherwise
        need remapping too)."""
        if not any(c is None for c in self._carriers):
            return
        used = np.unique(self._base_carrier) if len(self._base_carrier) \
            else np.empty(0, dtype=np.int32)
        remap = np.full(len(self._carriers), -1, dtype=np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        self._base_carrier = remap[self._base_carrier]
        self._carriers = [self._carriers[int(c)] for c in used]
        self._carrier_ids = {}
        for i, c in enumerate(self._carriers):
            try:
                self._carrier_ids[c] = i
            except TypeError:
                pass  # unhashable carrier (load() tolerates them too)

    def _maybe_merge(self) -> None:
        if len(self._delta) >= max(65536, len(self._base_dig) // 4):
            self._merge()

    # -- API ---------------------------------------------------------------

    def lookup(self, digest: bytes):
        v = self._delta.get(digest)
        if v is not None:
            return self._compose(v[0], v[1])
        i = self._base_row(digest)
        if i < 0:
            return None
        return self._compose(int(self._base_carrier[i]),
                             int(self._base_off[i]))

    def lookup_batch(self, digests: Sequence[bytes]) -> list[Any]:
        """One vectorized searchsorted over the base for the whole batch
        (the engine judges chunks hundreds at a time)."""
        out: list[Any] = [None] * len(digests)
        if not digests:
            return out
        n = len(self._base_dig)
        if n:
            keys = np.array(list(digests), dtype="S20")
            idx = np.searchsorted(self._base_dig, keys)
            np.clip(idx, 0, n - 1, out=idx)
            hit = (self._base_dig[idx] == keys) & ~self._base_dead[idx]
            for j in np.nonzero(hit)[0]:
                i = int(idx[j])
                out[j] = self._compose(int(self._base_carrier[i]),
                                       int(self._base_off[i]))
        if self._delta:
            for j, d in enumerate(digests):
                v = self._delta.get(d)
                if v is not None:
                    out[j] = self._compose(v[0], v[1])
        return out

    def insert(self, digest: bytes, ref: Any) -> bool:
        """Insert if absent; returns True when this digest was new."""
        if digest in self._delta or self._base_row(digest) >= 0:
            return False
        carrier, off = self._decompose(ref)
        self._delta[digest] = (self._cid(carrier), off)
        self._len += 1
        self._maybe_merge()
        return True

    def remove(self, digest: bytes) -> bool:
        if self._delta.pop(digest, None) is not None:
            self._len -= 1
            return True
        i = self._base_row(digest)
        if i < 0:
            return False
        self._base_dead[i] = True
        self._dead += 1
        self._len -= 1
        return True

    def items(self):
        """Live (digest, ref) pairs — delta first, then base.  Base
        digests are re-padded to the full 20 bytes: numpy ``S20`` scalars
        strip trailing NULs on extraction, which would silently shorten
        ~1/256 SHA1 digests for byte-equality consumers."""
        for d, (cid, off) in self._delta.items():
            yield d, self._compose(cid, off)
        for i in range(len(self._base_dig)):
            if not self._base_dead[i]:
                yield bytes(self._base_dig[i]).ljust(20, b"\0"), self._compose(
                    int(self._base_carrier[i]), int(self._base_off[i]))

    def remove_by_carrier(self, carrier: Any) -> int:
        """Tombstone every live entry attributed to ``carrier`` (a deleted
        file id) — one vectorized mask over the base carrier column plus a
        delta scan, so `forget` needs no per-file side table of digest
        lists (which would reintroduce the per-entry object overhead this
        columnar layout exists to avoid).  Returns the number removed."""
        cid = self._carrier_ids.get(carrier)
        if cid is None:
            return 0
        dead_delta = [d for d, v in self._delta.items() if v[0] == cid]
        for d in dead_delta:
            del self._delta[d]
        n = len(dead_delta)
        if len(self._base_dig):
            hit = (self._base_carrier == cid) & ~self._base_dead
            k = int(hit.sum())
            if k:
                self._base_dead[hit] = True
                self._dead += k
                n += k
        self._len -= n
        # Release the interned id now (the string itself at the next
        # merge): churned file ids must not accumulate in the carrier
        # table or its snapshots.
        self._carriers[cid] = None
        del self._carrier_ids[carrier]
        return n

    # -- persistence (checkpoint/resume parity; SURVEY.md §5) -------------

    def save(self, path: str) -> None:
        self._merge()  # snapshot = one sorted columnar base
        _atomic_savez(
            path, compress=False,  # SHA1 columns are incompressible
            digests=self._base_dig.view(np.uint8),
            carrier_idx=self._base_carrier, offsets=self._base_off,
            carriers=np.array([json.dumps(c) for c in self._carriers],
                              dtype=object),
            exact_spec=_EXACT_SPEC)

    @classmethod
    def load(cls, path: str) -> "ExactDigestIndex":
        data = np.load(_npz_path(path), allow_pickle=True)
        idx = cls()
        if "exact_spec" not in data:  # v1: flat bytes + per-entry json refs
            raw = data["digests"].tobytes()
            refs = data["refs"]
            for i in range(len(refs)):
                idx.insert(raw[i * 20:(i + 1) * 20], json.loads(str(refs[i])))
            return idx
        idx._base_dig = np.ascontiguousarray(data["digests"]).view("S20")
        idx._base_carrier = np.asarray(data["carrier_idx"], dtype=np.int32)
        idx._base_off = np.asarray(data["offsets"], dtype=np.int64)
        idx._base_dead = np.zeros(len(idx._base_dig), dtype=bool)
        idx._carriers = [json.loads(str(c)) for c in data["carriers"]]
        idx._carrier_ids = {}
        for i, c in enumerate(idx._carriers):
            try:
                idx._carrier_ids[c] = i
            except TypeError:  # unhashable carrier (e.g. json list)
                pass
        idx._len = len(idx._base_dig)
        return idx


class MinHashLSHIndex:
    """Near-duplicate index: LSH band buckets over MinHash signatures.

    ``num_perms = bands * rows``.  A query hashes each signature band;
    items sharing any band bucket become candidates, then the true
    signature-agreement score is computed vectorized against the stored
    signature matrix (host numpy) and thresholded.
    """

    def __init__(self, num_perms: int = 64, bands: int = 16) -> None:
        if num_perms % bands:
            raise ValueError(f"bands {bands} must divide num_perms {num_perms}")
        self.num_perms = num_perms
        self.bands = bands
        self.rows = num_perms // bands
        self._buckets: list[dict[bytes, list[int]]] = [{} for _ in range(bands)]
        # Rows accumulate in a list (O(1) amortized add); the dense matrix is
        # materialized lazily and cached for queries.
        self._rows: list[np.ndarray] = []
        self._sigs_cache: np.ndarray | None = None
        self._refs: list[Any] = []
        # ref -> ALL item ids carrying it (hashable refs only): O(1)
        # signature_of (latest id) and O(items-of-ref) remove — a linear
        # _refs scan per delete would make churn quadratic at the scale
        # the exact index is engineered for.
        self._ids_by_ref: dict[Any, list[int]] = {}
        self._dead = 0  # tombstoned rows (compacted when they dominate)
        self.stack_rebuilds = 0   # times the signature matrix was built
        self.candidates = 0       # band candidates (tombstones too), summed

    def __len__(self) -> int:
        return len(self._refs)

    def counts(self) -> dict[str, int]:
        """Rows (tombstones included) and tombstones, the matrix's
        rebuilds, and the candidates all queries scored."""
        return {"near_rows": len(self._refs), "near_dead": self._dead,
                "near_stack_rebuilds": self.stack_rebuilds,
                "near_candidates": self.candidates}

    def _band_keys(self, sig: np.ndarray) -> list[bytes]:
        return [sig[b * self.rows:(b + 1) * self.rows].tobytes()
                for b in range(self.bands)]

    def add(self, sig: np.ndarray, ref: Any) -> int:
        """Insert; returns the item id, or -1 for an all-``EMPTY``
        signature (a chunk/file with no sketch survivors carries no
        similarity information — indexing it would make every such item
        a spurious 1.0-score near-dup of every other)."""
        sig = np.asarray(sig, dtype=np.uint32)
        if sig.shape != (self.num_perms,):
            raise ValueError(f"signature shape {sig.shape} != ({self.num_perms},)")
        if (sig == EMPTY).all():
            return -1
        item = len(self._refs)
        self._refs.append(ref)
        self._rows.append(sig)
        self._sigs_cache = None
        try:
            self._ids_by_ref.setdefault(ref, []).append(item)
        except TypeError:
            pass  # unhashable ref: signature_of/remove unsupported for it
        for b, key in enumerate(self._band_keys(sig)):
            self._buckets[b].setdefault(key, []).append(item)
        return item

    def query(self, sig: np.ndarray, top_k: int = 5,
              min_similarity: float = 0.5, spans=None
              ) -> list[tuple[Any, float]]:
        """Top-k near-dup candidates with signature-agreement scores.

        Scoring is plain numpy: a per-query candidate set is at most a
        few thousand rows, where host vector ops win outright — eager
        accelerator dispatch costs ~ms per op (tens of ms on a remote
        backend), turning a retrieval sweep into dispatch overhead.  The
        mesh-sharded query path uses the :attr:`signatures` matrix with
        its own jitted collectives instead.

        ``spans``, a ``trace.CallSpans`` recorder with a call open, gets
        the query's stages as children: ``index.near_candidates``, then
        ``index.near_stack`` where the matrix is rebuilt, then
        ``index.near_score``.
        """
        sig = np.asarray(sig, dtype=np.uint32)
        if (sig == EMPTY).all():
            return []
        cand: set[int] = set()
        for b, key in enumerate(self._band_keys(sig)):
            cand.update(self._buckets[b].get(key, ()))
        self.candidates += len(cand)
        # Tombstones leave before the ranking: a deleted file's rows must
        # not take places of the top k from live ones (the JAX package
        # ranks them and drops them after, so a file uploaded and deleted
        # again and again crowds its own report empty).
        refs = self._refs
        ids = np.fromiter((i for i in cand if refs[i] is not None),
                          dtype=np.int64)
        if spans is not None:
            spans.end(NEAR_CANDIDATES)
        if not len(ids):
            return []
        rebuilt = self._sigs_cache is None
        sigs = self.signatures
        if spans is not None and rebuilt:
            spans.end(NEAR_STACK)
        scores = (sigs[ids] == sig[None, :]).mean(axis=1, dtype=np.float32)
        order = np.argsort(-scores)[:top_k]
        out = [(refs[int(ids[i])], float(scores[i])) for i in order
               if scores[i] >= min_similarity]
        if spans is not None:
            spans.end(NEAR_SCORE)
        return out

    def remove(self, ref: Any) -> int:
        """Tombstone every item carrying ``ref`` (deleted file); queries
        skip tombstones.  When tombstones outnumber live rows the whole
        index compacts (ids, rows, buckets rebuilt) — without this,
        create/delete churn grows signature storage and band buckets
        without bound.  Returns the number of items removed."""
        try:
            ids = self._ids_by_ref.pop(ref, None)
        except TypeError:
            # Unhashable refs never enter the ref map — fall back to the
            # linear scan so they still tombstone.
            ids = [i for i, r in enumerate(self._refs) if r == ref]
            for i in ids:
                self._refs[i] = None
            self._dead += len(ids)
            self._maybe_compact()
            return len(ids)
        if not ids:
            return 0
        for i in ids:
            self._refs[i] = None
        self._dead += len(ids)
        self._maybe_compact()
        return len(ids)

    def _maybe_compact(self) -> None:
        if self._dead <= max(len(self._refs) - self._dead, 1024):
            return
        live = [i for i, r in enumerate(self._refs) if r is not None]
        self._refs = [self._refs[i] for i in live]
        self._rows = [self._rows[i] for i in live]
        self._sigs_cache = None
        self._dead = 0
        self._reindex()

    def _reindex(self) -> None:
        """Rebuild band buckets + the ref map from _refs/_rows (shared by
        snapshot load and tombstone compaction)."""
        self._buckets = [{} for _ in range(self.bands)]
        self._ids_by_ref = {}
        for item, (ref, sig) in enumerate(zip(self._refs, self._rows)):
            for b, key in enumerate(self._band_keys(sig)):
                self._buckets[b].setdefault(key, []).append(item)
            if ref is not None:
                try:
                    self._ids_by_ref.setdefault(ref, []).append(item)
                except TypeError:
                    pass

    def signature_of(self, ref: Any) -> np.ndarray | None:
        """Latest stored signature for ``ref`` (None when unindexed or
        removed) — the entry point for ref-keyed near-dup queries."""
        try:
            ids = self._ids_by_ref.get(ref)
        except TypeError:
            return None
        return self._rows[ids[-1]] if ids else None

    @property
    def signatures(self) -> np.ndarray:
        """The (N, P) stored signature matrix (for sharded/mesh queries)."""
        if self._sigs_cache is None:
            self._sigs_cache = (np.stack(self._rows) if self._rows
                                else np.zeros((0, self.num_perms), np.uint32))
            self.stack_rebuilds += 1
        return self._sigs_cache

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        _atomic_savez(
            path, sigs=self.signatures,
            refs=np.array([json.dumps(r) for r in self._refs], dtype=object),
            num_perms=self.num_perms, bands=self.bands,
            sig_spec=SIG_SPEC_VERSION)

    @classmethod
    def load(cls, path: str) -> "MinHashLSHIndex":
        data = np.load(_npz_path(path), allow_pickle=True)
        spec = int(data["sig_spec"]) if "sig_spec" in data else 1
        if spec != SIG_SPEC_VERSION:
            raise ValueError(
                f"near-dup index snapshot {path!r} holds spec-v{spec} "
                f"signatures, this build computes spec-v{SIG_SPEC_VERSION}; "
                "the sets are not comparable — delete the snapshot and "
                "re-ingest (exact dedup state is unaffected)")
        idx = cls(int(data["num_perms"]), int(data["bands"]))
        sigs = np.asarray(data["sigs"], dtype=np.uint32)
        idx._rows = list(sigs)
        idx._sigs_cache = sigs if len(sigs) else None
        idx._refs = [json.loads(str(r)) for r in data["refs"]]
        idx._reindex()
        idx._dead = sum(1 for r in idx._refs if r is None)
        return idx


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_savez(path: str, compress: bool = True, **arrays) -> None:
    """Write-then-rename snapshot (reference: tracker_save_storages() writes
    its ``.dat`` files the same way for crash consistency).  compress=False
    for columns that will not compress (e.g. SHA1 digests) — at tens of
    millions of entries the zlib pass dominates snapshot time."""
    final = _npz_path(path)
    tmp = final + ".tmp"
    (np.savez_compressed if compress else np.savez)(tmp, **arrays)
    # np.savez appends .npz to paths without it.
    os.replace(tmp + ".npz", final)
