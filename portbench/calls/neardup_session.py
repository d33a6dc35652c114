"""The call of a crawler's upload session on a storage node's sidecar:
the requests a ``fdfs_storaged`` with ``dedup_mode = sidecar`` makes for
one page of at least ``dedup_chunk_threshold`` bytes, and the client's
near-duplicate report and delete, through ``DedupSidecar.handle`` (the
sidecar's own request path, without the socket):

1. ``DEDUP_FINGERPRINT_CUTS`` (125) with the page's cuts;
2. ``DEDUP_COMMIT`` ``commitchunks <session> <file_id>``;
3. ``DEDUP_NEARDUPS`` (123) for the file;
4. ``DEDUP_COMMIT`` ``forget <file_id>`` where the report lists any file.

The system under test is one sidecar on the cell's card whose indexes
hold the corpus's ``store_pages`` stored pages (``corpora/html.py``'s
store, ids ``group1/S/<j>``), loaded at set-up 64 MiB at a time: one
``fingerprint(data, cuts)`` call over ``dedup_segment_bytes`` of pages,
each page with its own cuts (the daemon chunks every upload alone), then
``commit_chunks`` for each page, which makes ``commitchunks``' updates.
Uploads take ids ``group1/W/<n>`` from one counter of the process.

Every call is held to its rows: its chunks as its cuts make them and the
four statuses 0 (``session_rows_wrong``; no ``forget`` reads 0).  A
compared call is held whole to ``portbench.neardup_reference``, each
number with the limit 0:

- ``spans_wrong``, ``digests_wrong``: each chunk's span and SHA-1;
- ``reports_wrong``: the stored pages the report lists, with their
  scores, must be those of the page's planted group (its base's four
  stored pages) that the LSH rule reports; a stored page of another
  group must be one the rule reports, with its score (the page is made
  again and signed); a line that names no stored page or upload, or
  names one twice, counts too;
- ``window_refs_wrong``: each upload the report lists must be one of a
  pool page the rule reports against this page, with its score, whose
  ``commitchunks`` began before the report returned and whose ``forget``
  had not returned when the report was asked for.  Within those times
  an upload's presence depends on the streams' timing, so it is free
  and its content exact.

After the window the sidecar's indexes are held to every upload the
run made, warm-up's too (``index_state_wrong``, limit 0): a forgotten
upload has no signature in the LSH index and carries none of its chunks
in the exact index; a kept one has its signature, and each of its
chunks is indexed, unless a forgotten upload holding the chunk began its
commit before the kept one's ended (it may have carried the chunk, and
took it away).

Another group's stored page that the rule would report and the report
leaves out is not seen: random text over the configuration's vocabulary
makes one unlikely (``tests/test_torch_neardup_session.py`` holds a
small store's reports to the rule over every stored page).
"""

from __future__ import annotations

import itertools
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, fields
from functools import partial

import numpy as np

from portbench import cdc, check, corpus
from portbench import neardup_reference as nd

ROWS_WRONG = "session_rows_wrong"
LIMITS = {
    "session_rows_wrong": 0,   # calls whose chunks or statuses are off
    "spans_wrong": 0,          # chunks of compared calls, each field
    "digests_wrong": 0,
    "reports_wrong": 0,        # stored refs of compared reports
    "window_refs_wrong": 0,    # upload refs of compared reports
    "index_state_wrong": 0,    # uploads the indexes hold wrongly at the end
}

_I64 = struct.Struct(">q")
# A 125 response row: offset, length, raw SHA-1 as five big-endian words.
_CHUNK = np.dtype([("off", ">i8"), ("len", ">i8"), ("dig", ">u4", (5,))])
_UPLOADS = itertools.count()


@dataclass
class Page:
    data: bytes
    cuts: list[int]
    lens: np.ndarray    # the chunks' lengths
    index: int          # place in the pool
    kind: str           # corpora/html.py's class
    base: int           # the stored group it was made from
    cut_table: bytes    # the 125 body's cut count and cut ends


@dataclass
class Upload:
    """One upload of a pool page, with the times (``time.perf_counter``)
    its requests began or returned."""
    index: int              # the pool page
    digests: list = field(default_factory=list)   # raw, from the 125
    commit: float = float("inf")       # commitchunks sent
    committed: float = float("inf")    # commitchunks returned
    forgotten: float | None = None     # forget returned


@dataclass
class Node:
    sidecar: object
    cmd: object         # the program's StorageCmd
    uploads: dict       # upload id -> Upload


@dataclass
class Session:
    spans: np.ndarray
    digests: np.ndarray
    statuses: tuple     # 125, commitchunks, 123, forget (0: not sent)
    stored: list        # (stored page, score) of the report's lines
    window: list        # (upload id, score) of upload lines
    other: int          # lines that name neither
    asked: float        # NEARDUPS sent (time.perf_counter)
    answered: float     # NEARDUPS returned
    node: Node = field(repr=False)  # the system, checked after the window


@dataclass(frozen=True)
class Expected(nd.Answer):
    """The reference's answer for a page, with the stored pages of its
    group and how to sign any stored page."""
    group: frozenset = frozenset()
    signed: object = None   # stored page -> its file signature, or None


def make_system(cell, device):
    from fastdfs_tpu_torch.common.protocol import StorageCmd
    from fastdfs_tpu_torch.dedup.engine import DedupConfig
    from fastdfs_tpu_torch.sidecar import DedupSidecar

    d, cfg = cell.dedup, cell.config
    config = DedupConfig(
        min_size=d["min_size"], avg_bits=d["avg_bits"],
        max_size=d["max_size"], num_perms=d["num_perms"],
        shingle=d["shingle"], lsh_bands=cfg["lsh_bands"],
        near_dup_threshold=cfg["near_dup_threshold"],
        near_dup_top_k=cfg["near_dup_top_k"], fan_out=cell.chips)
    sidecar = DedupSidecar("", None, config, device=device)
    sidecar.engine.warmup()
    preload(sidecar, cell, device)
    return Node(sidecar, StorageCmd, {})


def preload(sidecar, cell, device) -> None:
    """Index the store: each call's pages made (the next call's while
    this one runs), cut, fingerprinted in one call and committed."""
    c, d = cell.config["corpus"], cell.dedup
    groups = c["store_pages"] // 4
    step = cell.config["dedup_segment_bytes"] // c["page_bytes"] // 4
    spent = dict.fromkeys(("make", "cuts", "fingerprint", "commit"), 0.0)

    def make(lo):
        t = time.monotonic()
        pages = cell.corpus.store_groups(c, lo, min(lo + step, groups),
                                         device)
        spent["make"] += time.monotonic() - t
        return pages

    with ThreadPoolExecutor(max_workers=1) as ex:
        ahead = ex.submit(make, 0)
        for lo in range(0, groups, step):
            pages = ahead.result()
            if lo + step < groups:
                ahead = ex.submit(make, lo + step)
            _load(sidecar, pages, 4 * lo, d, device, spent)
    print(f"set-up: {4 * groups} stored pages indexed; seconds making "
          + ", ".join(f"{k} {v:.3f}" for k, v in spent.items())
          + f"; {len(sidecar.engine.exact)} chunk digests", file=sys.stderr,
          flush=True)


def page_cuts(cand: np.ndarray, pages: int, size: int, min_size: int,
              max_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``cdc.select_cuts`` run on each of ``pages`` pages of ``size``
    bytes end to end, all pages a step at a time: the cuts' ends in the
    whole (ascending) and how many each page has.  ``cand`` holds the
    candidates of the whole; min_size exceeds the gear window, so a page's
    cuts never take a candidate that the page before it reaches into."""
    start = np.arange(pages, dtype=np.int64) * size
    end = start + size
    top = np.searchsorted(cand, end)          # a page's candidates end here
    cand = np.append(cand, 0)
    last = start.copy()
    live = np.arange(pages)
    cuts = []
    while len(live):
        at = last[live]
        lo = np.searchsorted(cand[:-1], at + min_size - 1)
        hi = np.minimum(np.searchsorted(cand[:-1], at + max_size - 1,
                                        side="right"), top[live])
        has = lo < hi
        go = has | (end[live] - at > max_size)
        cut = np.where(has, cand[lo] + 1, at + max_size)[go]
        cuts.append(cut)
        last[live[go]] = cut
        live = live[go]
    short = last < end
    cuts.append(end[short])
    every = np.sort(np.concatenate(cuts))
    return every, np.bincount((every - 1) // size,
                              minlength=pages)


def _load(sidecar, pages: np.ndarray, first: int, d: dict, device,
          spent: dict) -> None:
    t = time.monotonic()
    n, size = pages.shape
    flat = pages.reshape(-1)
    cuts, counts = page_cuts(cdc.gear_candidates(flat, d["avg_bits"], device),
                             n, size, d["min_size"], d["max_size"])
    t1 = time.monotonic()
    spans, digests, sigs = sidecar.engine.fingerprint(flat, cuts)
    raw = np.asarray(digests, dtype=">u4").tobytes()
    offsets = [off for off, _ in spans]
    t2 = time.monotonic()
    row = 0
    for p, k in enumerate(counts.tolist()):
        sidecar.commit_chunks(
            f"group1/S/{first + p}",
            [(raw[20 * i:20 * i + 20], offsets[i] - p * size)
             for i in range(row, row + k)],
            sigs[row:row + k].min(axis=0))
        row += k
    spent["cuts"] += t1 - t
    spent["fingerprint"] += t2 - t1
    spent["commit"] += time.monotonic() - t2


def prepare(cell, datas: list[bytes], device) -> list[Page]:
    """Each pool page with the daemon's cuts, worked out on ``device``,
    and its class and stored group from the corpus's plan."""
    d = cell.dedup
    plans = corpus.Corpus(cell.config["corpus"],
                          int(cell.traffic["segment_bytes"]), len(datas), 0,
                          cell.corpus).plans
    out = []
    for i, (data, (kind, base)) in enumerate(zip(datas, plans)):
        cuts = cdc.chunk_cuts(data, d["min_size"], d["avg_bits"],
                              d["max_size"], device)
        out.append(Page(data, cuts, np.diff(cuts, prepend=0), i, kind, base,
                        _I64.pack(len(cuts))
                        + np.asarray(cuts, ">i8").tobytes()))
    return out


def call(system: Node, item: Page) -> Session:
    n = next(_UPLOADS)
    file_id = f"group1/W/{n}"
    up = system.uploads[file_id] = Upload(item.index)
    handle, cmd = system.sidecar.handle, system.cmd
    fp, resp = handle(cmd.DEDUP_FINGERPRINT_CUTS,
                      _I64.pack(n) + _I64.pack(0) + item.cut_table
                      + item.data)
    spans, digests = _chunks(resp)
    up.digests = _raw(digests)
    up.commit = time.perf_counter()
    commit, _ = handle(cmd.DEDUP_COMMIT,
                       f"commitchunks {n} {file_id}".encode())
    up.committed = asked = time.perf_counter()
    near, report = handle(cmd.DEDUP_NEARDUPS, file_id.encode())
    answered = time.perf_counter()
    forget = 0
    if report:
        forget = handle(cmd.DEDUP_COMMIT, f"forget {file_id}".encode())[0]
        up.forgotten = time.perf_counter()
    return Session(spans, digests, (fp, commit, near, forget),
                   *_report(report), asked, answered, system)


def _raw(digests: np.ndarray) -> list[bytes]:
    raw = np.asarray(digests, dtype=">u4").tobytes()
    return [raw[i:i + 20] for i in range(0, len(raw), 20)]


def _chunks(resp: bytes) -> tuple[np.ndarray, np.ndarray]:
    n = _I64.unpack_from(resp)[0] if len(resp) >= 8 else 0
    rows = np.frombuffer(resp, dtype=_CHUNK, count=n, offset=8) if n \
        else np.zeros(0, _CHUNK)
    return (np.stack([rows["off"], rows["len"]], axis=1).astype(np.int64),
            rows["dig"].astype(np.uint32))


def _report(report: bytes) -> tuple[list, list, int]:
    stored, window, other = [], [], 0
    for line in report.decode("utf-8", "replace").splitlines():
        ref, _, score = line.partition(" ")
        kind, _, key = ref.removeprefix("group1/").partition("/")
        if kind == "S" and key.isdigit():
            stored.append((int(key), score))
        elif kind == "W":
            window.append((ref, score))
        else:
            other += 1
    return stored, window, other


def rows(answer: Session) -> tuple[int, ...]:
    return (len(answer.spans), *answer.statuses)


def expected_rows(item: Page, cell) -> tuple[int, ...]:
    return (len(item.cuts), 0, 0, 0, 0)


def _signed(cell, j: int) -> np.ndarray | None:
    """Stored page ``j``'s file signature, made again from the store."""
    c = cell.config["corpus"]
    if not 0 <= j < c["store_pages"]:
        return None
    page = cell.corpus.store_groups(c, j // 4, j // 4 + 1)[j % 4]
    return nd.signature(page.tobytes(), cell.dedup)


def reference(item: Page, cell) -> Expected:
    cfg = cell.config
    group = cell.corpus.store_groups(cfg["corpus"], item.base, item.base + 1)
    stored = {4 * item.base + r: nd.signature(page.tobytes(), cell.dedup)
              for r, page in enumerate(group)}
    ans = nd.answer(item.data, item.cuts, stored, cell.dedup,
                    cfg["lsh_bands"], cfg["near_dup_threshold"])
    return Expected(**{f.name: getattr(ans, f.name) for f in fields(ans)},
                    group=frozenset(stored), signed=partial(_signed, cell))


def compare(kept: list[check.Kept], answers: dict) -> dict[str, int]:
    out = dict.fromkeys(("spans_wrong", "digests_wrong", "reports_wrong",
                         "window_refs_wrong", "index_state_wrong"), 0)
    for k in kept:
        got, ans = k.answer, answers[k.segment]
        out["spans_wrong"] += check.rows_wrong(
            got.spans, np.stack([ans.offsets, ans.lens], axis=1))
        out["digests_wrong"] += check.rows_wrong(got.digests, ans.digests)
        listed = set(got.stored)
        out["reports_wrong"] += got.other + len(got.stored) - len(listed) \
            + len(ans.stored ^ {p for p in listed if p[0] in ans.group})
        for j, score in listed - ans.stored:
            if j not in ans.group:
                sig = ans.signed(j)
                out["reports_wrong"] += sig is None or nd.reported(
                    ans.sig, sig, ans.bands, ans.threshold) != score
        for ref, score in got.window:
            up = got.node.uploads.get(ref)
            out["window_refs_wrong"] += (
                up is None or up.commit > got.answered
                or (up.forgotten is not None and up.forgotten < got.asked)
                or nd.reported(ans.sig, answers[up.index].sig, ans.bands,
                               ans.threshold) != score)
    if kept:
        out["index_state_wrong"] = index_state_wrong(kept[0].answer.node)
    return out


def index_state_wrong(node: Node) -> int:
    """The uploads the sidecar's indexes hold wrongly, each counted once
    (the module's docstring gives the rule)."""
    exact, near = node.sidecar.engine.exact, node.sidecar.engine.near
    gone = {}    # chunk -> the earliest commit of a forgotten upload of it
    for up in node.uploads.values():
        if up.forgotten is not None:
            for d in up.digests:
                gone[d] = min(gone.get(d, up.commit), up.commit)
    wrong = 0
    for ref, up in node.uploads.items():
        if up.forgotten is not None:
            wrong += near.signature_of(ref) is not None or any(
                r is not None and r[0] == ref
                for r in exact.lookup_batch(up.digests))
        else:
            wrong += near.signature_of(ref) is None or any(
                r is None and gone.get(d, up.committed) >= up.committed
                for d, r in zip(up.digests, exact.lookup_batch(up.digests)))
    return wrong


def notes(run) -> list[str]:
    """Each class's pages, how many have stored near-duplicates, and
    their calls."""
    out = []
    for kind in ("span", "scattered", "shuffle"):
        idx = [i for i, p in enumerate(run.pool) if p.kind == kind]
        lat = run.latency_s[np.isin(run.segment, idx)]
        dup = sum(1 for i in idx if run.answers[i].stored)
        out.append(f"{kind}: {len(idx)} pool pages, {dup} with stored "
                   f"near-duplicates, {len(lat)} calls, median "
                   f"{np.median(lat) * 1e3 if len(lat) else float('nan'):.3f}"
                   f" ms")
    return out
