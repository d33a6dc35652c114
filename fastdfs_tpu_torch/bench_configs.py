"""Benchmark configs 4 and 5 of ``BASELINE.json`` on the port.

The port of the device configs of the repository's root
``bench_configs.py``: one JSON artifact per config, in ``--out``
(``bench_torch_out/`` at the repository root by default):

  4. MinHash near-duplicate detection on synthetic web-crawl HTML
     (shingle 5), **the recall referee**: every document is signed by
     the fused sketch kernel (``minhash_batch_cuda``) fed through
     ``ops.streaming.stream_batches``, and retrieval through
     ``MinHashLSHIndex(64, 16)`` is held to the corpus's ground truth
     (target recall@1 >= 0.98) and to an independent textbook CPU
     MinHash on a subset;
  5. the 4-node storage group analogue: the distributed ingest step over
     a (2, 2, 2) mesh of eight ranks, all on one card (or the CPU), with
     the digest all-gather, the sharded near-dup query and the pmax.

Run from the repository root:

    python -m fastdfs_tpu_torch.bench_configs --config 4|5 [--scale F]
        [--out DIR] [--device cuda|cpu]

``--scale`` is the fraction of the nominal corpus size (``NOMINAL``)
that the run builds (``DEFAULT_SCALE`` by default); the artifact records
``scaled_bytes`` beside ``nominal_bytes``.  The rates in an artifact are
the card's on a ``cuda`` run and null on a ``cpu`` run, which checks the
same control flow on the plain twins.  Configs 1-3 and 6-14 drive the C++
daemons and are not ported here.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch

from fastdfs_tpu_torch.dedup.index import MinHashLSHIndex
from fastdfs_tpu_torch.ops import resolve_device
from fastdfs_tpu_torch.ops.cuda_minhash import minhash_batch_cuda
from fastdfs_tpu_torch.ops.minhash import minhash_batch
from fastdfs_tpu_torch.ops.streaming import stream_batches
from fastdfs_tpu_torch.parallel import distributed_ingest_step, make_mesh
from fastdfs_tpu_torch.tools.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "bench_torch_out")

NOMINAL = {4: 100 << 30, 5: 500 << 30}
DEFAULT_SCALE = {4: 1 / 40.0, 5: 1 / 2000.0}

BATCH = 256            # documents a streamed batch
STREAM_DEPTH = 3       # batches in flight
RESIDENT_DISPATCHES = 8
REFEREE_QUERIES = 512
C5_ITERATIONS = 16


def emit(out_dir: str, config: int, payload: dict) -> dict:
    """Write ``config{N}.json`` and print its scalar fields as one JSON
    line; returns the artifact."""
    payload = {"config": config, **payload}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"config{config}.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps({"config": config,
                      **{k: payload[k] for k in payload
                         if isinstance(payload[k], (int, float, str, bool))}}))
    return payload


def _html_corpus(total: int, seed=4):
    """Synthetic web-crawl: base pages, near-duplicate variants, and
    ADVERSARIAL content — the workload MinHash near-dup retrieval exists
    for, built so recall < 1.0 is genuinely possible.

    Returns (docs, lens, truth, klass):
      truth[i] = base index a variant must retrieve (-1: not a query)
      klass[i]: 0 base / 1 span-edit variant / 2 boundary-straddling
      single-byte edits (each edited byte damages `shingle` shingles —
      the worst case per byte) / 3 shuffled-shingle distractor (same
      token multiset as a base, re-ordered: overlapping vocabulary,
      almost no shared 5-grams — bait for any unigram-ish matcher).
    """
    rng = random.Random(seed)
    words = [f"tok{j}" for j in range(8000)]
    L = 64 << 10
    n_docs = max(total // L, 32)
    n_base = max(n_docs // 4, 8)
    docs = np.zeros((n_docs, L), dtype=np.uint8)
    truth = np.full(n_docs, -1, dtype=np.int64)
    klass = np.zeros(n_docs, dtype=np.int64)

    def page(body: str) -> bytes:
        html = (f"<html><head><title>p</title></head><body>{body}"
                "</body></html>").encode()
        return (html + b" " * L)[:L]

    nprng = np.random.RandomState(seed)
    for b in range(n_base):
        body = " ".join(rng.choices(words, k=L // 8))
        docs[b] = np.frombuffer(page(body), dtype=np.uint8)
    for i in range(n_base, n_docs):
        b = rng.randrange(n_base)
        kind = rng.random()
        if kind < 0.40:  # span-edit near-dup (typo/edit model, ~0.5%)
            row = docs[b].copy()
            for _ in range(max(L // (200 * 16), 1)):
                p = nprng.randint(0, L - 16)
                row[p:p + 16] = nprng.randint(97, 123, 16, dtype=np.uint8)
            truth[i] = b
            klass[i] = 1
        elif kind < 0.80:  # scattered single-byte edits (same edited
            # byte budget as the span class, ~5x the shingle damage)
            row = docs[b].copy()
            pos = nprng.choice(L, size=max(L // 200, 1), replace=False)
            row[pos] = nprng.randint(97, 123, len(pos), dtype=np.uint8)
            truth[i] = b
            klass[i] = 2
        else:  # shuffled-shingle distractor: index pollution, never a
            # correct answer for any query
            toks = bytes(docs[b]).split(b" ")
            rng.shuffle(toks)
            row = np.frombuffer((b" ".join(toks) + b" " * L)[:L],
                                dtype=np.uint8).copy()
            klass[i] = 3
        docs[i] = row
    lens = np.full(n_docs, L, dtype=np.int32)
    return docs, lens, truth, klass


def _textbook_minhash(docs: np.ndarray, lens: np.ndarray, num_perms: int,
                      shingle: int, seed: int = 99) -> np.ndarray:
    """Independent CPU MinHash referee: the TEXTBOOK formulation (k
    universal-hash permutations over the exact shingle set, one min
    each) in plain numpy — shares no code, spec, or hash family with
    the port's ``ops.minhash`` (a survivor sketch over a single hash), so
    agreement between the two retrieval rankings is an empirical result,
    not an identity."""
    rng = np.random.RandomState(seed)
    p = np.uint64((1 << 61) - 1)  # Mersenne prime
    # a < 2^23 keeps a*x + b below 2^64 for 40-bit shingle ints (shingle
    # 5), so the mod-p hash is computed exactly in uint64.
    a = rng.randint(1, 1 << 23, size=num_perms).astype(np.uint64)
    b = rng.randint(0, 1 << 61, size=num_perms).astype(np.uint64)
    sigs = np.zeros((len(docs), num_perms), dtype=np.uint64)
    for i in range(len(docs)):
        row = docs[i, :lens[i]].astype(np.uint64)
        # pack each `shingle`-byte window into one integer
        x = np.zeros(max(len(row) - shingle + 1, 0), dtype=np.uint64)
        for k in range(shingle):
            x |= row[k:len(row) - shingle + 1 + k] << np.uint64(8 * k)
        x = np.unique(x)
        # h_j(x) = (a_j * x + b_j) mod p over the shingle set, one min
        # per permutation (vectorized (P, S) broadcast).  p is Mersenne,
        # so the reduction is shift+mask+one conditional subtract — a
        # uint64 `%` here costs ~5x the rest of the referee combined.
        y = a[:, None] * x[None, :] + b[:, None]
        y = (y >> np.uint64(61)) + (y & p)
        y = np.where(y >= p, y - p, y)
        sigs[i] = y.min(axis=1)
    return sigs


def _fetch(outs) -> list:
    """Every dispatch's signatures copied back to the host (the fence)."""
    return [t.cpu() for t in outs]


def config4(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """MinHash near-dup on HTML — the recall referee, made falsifiable.

    Three measurements, none structurally guaranteed:
      1. recall@{1,5} of the kernel path's retrieval against ground truth
         on a corpus with adversarial distractors (shuffled-shingle
         pages) and worst-case edit classes — LSH banding and 64-perm
         sketches genuinely can miss here;
      2. top-1 agreement between the kernel path and an INDEPENDENT
         textbook CPU MinHash (different hash family, different
         estimator, no shared code) on a subset;
      3. the kernel's signatures of the first batch against the plain
         twin's on the CPU, bit for bit (a correctness property of the
         kernel, reported separately: it is not the recall measurement;
         null on a CPU run, where both sides are the plain twin).
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    total = int(NOMINAL[4] * scale)
    docs, lens, truth, klass = _html_corpus(total)
    n_docs = len(docs)
    n_base = int((klass == 0).sum())

    # the kernel path: the fused k = 5 sketch fed by windowed host->card
    # streaming (ops/streaming.py)
    batches = [(docs[i:i + BATCH], lens[i:i + BATCH])
               for i in range(0, n_docs, BATCH)]
    t0 = time.perf_counter()
    sigs_acc = np.concatenate(list(stream_batches(
        iter(batches), minhash_batch_cuda, depth=STREAM_DEPTH, device=dev)))
    acc_dt = time.perf_counter() - t0

    # card-resident rate (isolates the kernel from the host link)
    resident_gbps = None
    kernel_bitexact = None
    if on_card:
        db = torch.from_numpy(batches[0][0]).to(dev)
        dl = torch.from_numpy(batches[0][1]).to(dev)
        _fetch([minhash_batch_cuda(db, dl)])
        t0 = time.perf_counter()
        _fetch([minhash_batch_cuda(db, dl)
                for _ in range(RESIDENT_DISPATCHES)])
        resident_gbps = (RESIDENT_DISPATCHES * batches[0][0].size
                         / (time.perf_counter() - t0) / 1e9)
        sigs_ref0 = minhash_batch(torch.from_numpy(batches[0][0]),
                                  torch.from_numpy(batches[0][1])).numpy()
        kernel_bitexact = bool(np.array_equal(sigs_acc[:len(sigs_ref0)],
                                              sigs_ref0))

    # (1) retrieval vs ground truth: bases AND adversarial distractors
    # are indexed; each edit-variant queries for its true base.  (The
    # variants themselves stay out of the index so every query has
    # exactly one correct answer — sibling variants of the same base
    # would otherwise be equally-valid retrievals.)
    def retrieve(sigs, queries, top_k):
        idx = MinHashLSHIndex(64, 16)
        for d in range(n_docs):
            if d not in queries:
                idx.add(np.asarray(sigs[d], dtype=np.uint32)
                        if sigs.dtype != np.uint32 else sigs[d], d)
        out = {}
        for q in queries:
            got = idx.query(np.asarray(sigs[q], dtype=np.uint32)
                            if sigs.dtype != np.uint32 else sigs[q],
                            top_k=top_k, min_similarity=0.0)
            out[q] = [ref for ref, _ in got]
        return out

    queries = [int(q) for q in np.nonzero(truth >= 0)[0]]
    acc_top = retrieve(sigs_acc, set(queries), 5)
    r1 = sum(1 for q in queries if acc_top[q][:1] == [truth[q]])
    r5 = sum(1 for q in queries if truth[q] in acc_top[q])
    per_class = {}
    for cname, cid in (("span_edit", 1), ("scattered_edit", 2)):
        qs = [q for q in queries if klass[q] == cid]
        if qs:
            per_class[cname] = round(
                sum(1 for q in qs if acc_top[q][:1] == [truth[q]]) / len(qs),
                4)

    # (2) independent textbook CPU referee on a subset: do the two
    # pipelines RANK the same best match?  (Capped: the textbook path is
    # an O(perms x shingles) scalar-ish loop.)
    sub_q = queries[:min(len(queries), REFEREE_QUERIES)]
    sub_docs = sorted({*range(n_base), *sub_q})
    remap = {d: i for i, d in enumerate(sub_docs)}
    t0 = time.perf_counter()
    tb_sigs = _textbook_minhash(docs[sub_docs], lens[sub_docs],
                                num_perms=64, shingle=5)
    tb_dt = time.perf_counter() - t0

    def tb_top1(q):
        # brute-force exact top-1 under the textbook estimator
        qi = remap[q]
        scores = (tb_sigs[:n_base] == tb_sigs[qi]).mean(axis=1)
        return int(np.argmax(scores))

    agree = 0
    tb_r1 = 0
    for q in sub_q:
        t = tb_top1(q)
        agree += acc_top[q][:1] == [t]
        tb_r1 += t == truth[q]
    recall1 = r1 / len(queries) if queries else 1.0
    return emit(out_dir, 4, {
        "description": "MinHash near-dup on synthetic web-crawl HTML with "
                       "adversarial distractors, shingle 5 — falsifiable "
                       "recall referee (ground truth + independent "
                       "textbook CPU MinHash)",
        "nominal_bytes": NOMINAL[4], "scaled_bytes": int(docs.size),
        "docs": n_docs, "bases": n_base, "queries": len(queries),
        "distractors": int((klass == 3).sum()),
        "backend": dev.type,
        "card": card_line() if on_card else None,
        "batches": len(batches),
        "recall_at_1_vs_truth": round(recall1, 4),
        "recall_at_5_vs_truth": round(r5 / len(queries), 4) if queries else 1.0,
        "recall_per_class": per_class,
        "recall_target": 0.98,
        "recall_pass": recall1 >= 0.98,
        "referee_queries": len(sub_q),
        "referee_top1_agreement_acc_vs_textbook": round(
            agree / len(sub_q), 4) if sub_q else None,
        "referee_textbook_recall_at_1": round(
            tb_r1 / len(sub_q), 4) if sub_q else None,
        "referee_textbook_sig_seconds": round(tb_dt, 2),
        "kernel_bitexact_cuda_vs_plain": kernel_bitexact,
        "accelerated_sig_GBps_streamed": round(docs.size / acc_dt / 1e9, 4)
        if on_card else None,
        "accelerated_sig_GBps_resident": round(resident_gbps, 4)
        if on_card else None,
    })


def config5(out_dir: str, scale: float, device: str = "cuda") -> dict:
    """4-node-group analogue: the distributed ingest step over a
    (dp=2, sp=2, tp=2) mesh whose eight ranks all sit on one card (or the
    CPU), with the digest all-gather, the sharded index query and the
    pmax.  ``scale`` is recorded only: the shapes are the reference's."""
    dev = resolve_device(device)
    mesh = make_mesh(8, devices=[dev] * 8)  # dp x sp = 4-way node analogue
    rng = np.random.RandomState(5)
    N, L, M = 32, 2 << 10, 256
    stream = rng.randint(0, 256, (8, mesh.shape["sp"], 8192), np.uint8)
    index_sigs = rng.randint(0, 2 ** 32, (M, 64), np.uint64).astype(np.uint32)

    chunks = rng.randint(0, 256, (N, L), np.uint8)
    lens = np.full(N, L, np.int32)

    def run():
        out = distributed_ingest_step(mesh, stream, chunks, lens, index_sigs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    run()  # warm-up (builds the kernels on a first call)
    t0 = time.perf_counter()
    done = 0
    it = 0
    while it < C5_ITERATIONS:
        out = run()
        done += N * L + stream.size
        it += 1
    dt = time.perf_counter() - t0
    cand, digests, sigs, best = (x.cpu().numpy() for x in out)
    on_card = dev.type == "cuda"
    return emit(out_dir, 5, {
        "description": "4-node analogue: dp/sp/tp mesh ingest step with "
                       "digest all-gather + sharded near-dup query + pmax",
        "nominal_bytes": NOMINAL[5], "scaled_bytes": done,
        "scale": scale,
        "mesh": dict(mesh.shape), "iterations": it,
        "backend": dev.type,
        "card": card_line() if on_card else None,
        "seconds": round(dt, 3) if on_card else None,
        "aggregate_GBps": round(done / dt / 1e9, 6) if on_card else None,
        "steps_per_sec": round(it / dt, 3) if on_card else None,
        "note": "the eight ranks of the mesh share one "
                + ("card" if on_card else "CPU") + ": this config checks "
                "that the ranks' stages and the collectives (digest "
                "all-gather, tp sig all-gather, dp pmax) give the right "
                "shapes; "
                + ("the rate is one card's, not a 4-node group's"
                   if on_card else "no rate is reported off the card"),
        "digests_shape": list(digests.shape),
        "sigs_shape": list(sigs.shape),
        "candidates_shape": list(cand.shape),
        "best_shape": list(best.shape),
        "best_sim_finite": bool(np.isfinite(best).all()),
    })


CONFIGS = {4: config4, 5: config5}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="BASELINE.json configs 4 and 5 on the port")
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS),
                    required=True)
    ap.add_argument("--scale", type=float, default=None,
                    help="fraction of the nominal corpus size")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    scale = (args.scale if args.scale is not None
             else DEFAULT_SCALE[args.config])
    CONFIGS[args.config](args.out, scale, args.device)


if __name__ == "__main__":
    main()
