"""The call of a storage daemon's ``DEDUP_FINGERPRINT_CUTS`` request:
``DedupEngine.fingerprint(data, cuts)`` on one shared engine, as one
sidecar holds, with the daemon's CDC cuts (``portbench.cdc``) worked out
at set-up.

Every call is held to its rows: as many spans, digests and signatures as
the cuts make chunks, the digests five 32-bit words a row and the
signatures one a permutation (``chunk_counts_wrong``).  A compared call
is held whole to ``portbench.reference.answer``: every span, every
20-byte SHA-1 digest and every signature.  Each number has the limit 0:
the engine's answers are exact (the SHA-1 is the chunk's content
address, the signatures are the sketch's specification), so one
differing chunk is a wrong answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import cdc, check, roofline
from portbench import reference as plain

ROWS_WRONG = "chunk_counts_wrong"
LIMITS = {
    "chunk_counts_wrong": 0,    # calls whose rows are not the cuts' chunks
    "spans_wrong": 0,           # chunks of compared calls, each field
    "digests_wrong": 0,
    "sigs_wrong": 0,
}


@dataclass
class Segment:
    data: bytes
    cuts: list[int]
    lens: np.ndarray


def make_system(cell, device):
    from fastdfs_tpu_torch.dedup.engine import DedupConfig, DedupEngine

    d = cell.dedup
    cfg = DedupConfig(min_size=d["min_size"], avg_bits=d["avg_bits"],
                      max_size=d["max_size"], num_perms=d["num_perms"],
                      shingle=d["shingle"], fan_out=cell.chips)
    engine = DedupEngine(cfg, device=device)
    engine.warmup()
    return engine


def prepare(cell, datas: list[bytes], device) -> list[Segment]:
    """Each segment with the daemon's cuts, worked out on ``device``."""
    d = cell.dedup
    cuts = [cdc.chunk_cuts(b, d["min_size"], d["avg_bits"], d["max_size"],
                           device) for b in datas]
    return [Segment(b, c, plain.spans_of(c)[1]) for b, c in zip(datas, cuts)]


def call(system, item: Segment):
    return system.fingerprint(item.data, item.cuts)


def rows(answer) -> tuple[int, int, int, int]:
    """What every call is held to: its spans' count, its digests' and its
    signatures' rows, and the signatures' width; -1 for an array that is
    not 32-bit words in rows (digests five words wide)."""
    spans, digests, sigs = answer

    def shape(a, width=None):
        a = np.asarray(a)
        if a.ndim != 2 or a.dtype.itemsize != 4 or a.dtype.kind not in "iu" \
                or (width is not None and a.shape[1] != width):
            return -1, -1
        return a.shape

    return (len(spans), shape(digests, 5)[0], *shape(sigs))


def expected_rows(item: Segment, cell) -> tuple[int, int, int, int]:
    return (len(item.cuts),) * 3 + (cell.dedup["num_perms"],)


def reference(item: Segment, cell) -> plain.Answer:
    d = cell.dedup
    return plain.answer(item.data, item.cuts, d["shingle"], d["num_perms"])


def compare(kept: list[check.Kept], answers: dict) -> dict[str, int]:
    spans = digests = sigs = 0
    for k in kept:
        got_spans, got_digests, got_sigs = k.answer
        ans = answers[k.segment]
        got = np.asarray(got_spans, dtype=np.int64).reshape(-1, 2)
        spans += check.rows_wrong(
            got, np.stack([ans.offsets, ans.lens], axis=1))
        digests += check.rows_wrong(
            np.asarray(got_digests, dtype=np.uint32), ans.digests)
        sigs += check.rows_wrong(np.asarray(got_sigs, dtype=np.uint32),
                                 ans.sigs)
    return {"spans_wrong": spans, "digests_wrong": digests,
            "sigs_wrong": sigs}


def notes(run) -> list[str]:
    """Each segment's chunks, survivors and calls; in a traced run on a
    card of ``roofline.PEAKS``, SHA-1's chain bound."""
    out = []
    for i, seg in enumerate(run.pool):
        lat = run.latency_s[run.segment == i]
        out.append(
            f"segment {i}: {len(seg.cuts)} chunks, "
            f"{int((seg.lens == run.dedup['max_size']).sum())} of max size, "
            f"{run.answers[i].survivors} survivors, {len(lat)} calls, median "
            f"{np.median(lat) * 1e3 if len(lat) else float('nan'):.3f} ms")
    if run.peak:
        chain = max(roofline.sha1_chain_seconds(s.lens, run.peak)
                    for s in run.pool)
        out.append(f"sha1 chain bound (assumed latency, not a peak): "
                   f"{chain * 1e3:.4f} ms a segment")
    return out
