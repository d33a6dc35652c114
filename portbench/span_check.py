"""One traced run of a cell, and the engine's spans held to its device
trace: do the two clocks agree, did the ring keep the window, do a
call's stages cover it?

    python3 -m portbench.span_check --workload <cell> --seed <n> \\
        --seconds <s> [--out FILE]

Runs the cell as ``portbench.run --trace 1`` does, in this process, then
prints (and writes to ``--out``) one JSON object:

- ``result``: the run's result line, its per-layer metrics among it;
- ``device_op_names``: every device operation name of the window, whole
  and shortened, to compare with another checkout's;
- where the program keeps a span ring (``fastdfs_tpu_torch.trace``):
  ``ring``: its ``recorded``, ``dropped`` and whether it lost a span that
  ended inside the window; ``dtoh``: how many ``DtoH`` copies the window
  holds, the share that lies inside some ``engine.copy_back`` span, and
  over each copy and the copy-back span that overlaps it most, the
  least (copy start - span start) and (span end - copy end) in us: both
  at or above 0 on one clock, since a copy starts after its ``.cpu()``
  and that returns after it; ``calls``: the calls inside the window, the
  share of each root its children cover (least, median, and how many
  under 95%), each stage's median, 95th percentile, longest and share of
  the calls' time, and the median ``engine.fingerprint`` span beside the
  run's ``engine.call_p50_ms``.

The result line carries, beside the cell's metrics, the readers of
``metrics/`` that lay the spans over device operations (``UNLISTED``),
which the cells do not list yet.

It needs a CUDA card, as ``portbench.run`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np

from portbench import manifest, run, trace

# Readers of ``metrics/`` that lay the engine's spans over device
# operations; ``BENCHMARK.json`` lists none of them yet.
UNLISTED = ("engine.copy_back_host_ms", "device.idle_stage_copy_pct",
            "device.idle_copy_back_pct")


def against_copy_backs(cs, ce, ops) -> tuple[int, list, list]:
    """Each interval of ``ops`` against the copy-back spans ``[cs, ce)``:
    how many lie inside one, and for each that overlaps one, (its start -
    that span's start) and (that span's end - its end) in us, of the
    span it overlaps most."""
    inside, starts, ends = 0, [], []
    for x, y in ops:
        over = np.minimum(ce, y) - np.maximum(cs, x)
        if len(over) and over.max() > 0:
            k = int(np.argmax(over))
            starts.append((x - int(cs[k])) / 1e3)
            ends.append((int(ce[k]) - y) / 1e3)
        inside += bool(len(cs) and ((cs <= x) & (ce >= y)).any())
    return inside, starts, ends


def copy_back_spans(a: dict, names: list[str]):
    code = (names.index("engine.copy_back") if "engine.copy_back" in names
            else -1)
    return a["start_ns"][a["name"] == code], a["end_ns"][a["name"] == code]


def dtoh_check(a: dict, names: list[str], device: list) -> dict:
    """Each ``DtoH`` copy of the window against the copy-back spans."""
    ops = [(x, y) for n, x, y in device if "DtoH" in n]
    inside, starts, ends = against_copy_backs(*copy_back_spans(a, names), ops)
    return {"ops": len(ops), "inside_share": inside / len(ops) if ops else None,
            "overlapping": len(starts),
            "least_start_margin_us": min(starts) if starts else None,
            "least_end_margin_us": min(ends) if ends else None}


def calls_check(a: dict, names: list[str], p50_ms) -> dict:
    root = names.index("engine.fingerprint")
    is_root = a["name"] == root
    dur = a["end_ns"] - a["start_ns"]
    roots = dict(zip(a["call"][is_root].tolist(), dur[is_root].tolist()))
    kids: dict[int, int] = {}
    for c, d in zip(a["call"][~is_root].tolist(), dur[~is_root].tolist()):
        kids[c] = kids.get(c, 0) + d
    cover = [kids.get(c, 0) / max(1, d) for c, d in roots.items()]
    total_ms = sum(roots.values()) / 1e6
    med = float(np.median(list(roots.values()))) / 1e6 if roots else None
    stages = {}
    for code in sorted(set(a["name"].tolist()) - {root}):
        d = dur[a["name"] == code] / 1e6
        stages[names[code]] = {
            "count": len(d), "median_ms": float(np.median(d)),
            "p95_ms": float(np.percentile(d, 95)), "max_ms": float(d.max()),
            "share_of_calls": float(d.sum() / max(1e-9, total_ms))}
    return {"calls": len(roots),
            "least_cover": min(cover) if cover else None,
            "median_cover": float(np.median(cover)) if cover else None,
            "under_95pct": sum(c < 0.95 for c in cover),
            "stages": stages,
            "fingerprint_p50_ms": med, "call_p50_ms": p50_ms,
            "p50_difference_ms": (med - p50_ms
                                  if med is not None and p50_ms else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_check: CUDA is not available", file=sys.stderr)
        return 3
    from fastdfs_tpu_torch.tools.timing import card_line

    cell = manifest.cell(args.workload)
    # The unlisted readers report in the result line; a reader of its own
    # keeps the run, trace and all, for the checks below.
    kept = SimpleNamespace(read=lambda r: setattr(kept, "run", r))
    listed = {m.name for m in cell.per_layer}
    readers = {n: manifest.load_reader(manifest.ROOT, n)
               for n in UNLISTED if n not in listed}
    cell.per_layer += [manifest.Metric(n, {"unit": r.UNIT}, r)
                       for n, r in readers.items()]
    cell.per_layer.append(manifest.Metric("span_check", {"unit": ""}, kept))
    torch.set_num_threads(1)
    result, _ = run.run_cell(cell, args.seed, args.seconds, True,
                             torch.device("cuda", 0))
    t = kept.run.trace
    out = {"workload": args.workload, "seed": args.seed,
           "card": card_line(), "result": result,
           "device_op_names": sorted({n for n, _, _ in t.device}),
           "device_op_short_names": sorted({trace.short_name(n)
                                            for n, _, _ in t.device})}
    try:
        from fastdfs_tpu_torch.trace import SPAN_RING
    except ImportError:
        SPAN_RING = None
    if SPAN_RING is not None:
        w0, w1 = t.window
        a = SPAN_RING.arrays(w0, w1)
        names = list(SPAN_RING.names)
        p50 = result["metrics"].get("engine.call_p50_ms", {}).get("value")
        out["ring"] = {"recorded": SPAN_RING.recorded,
                       "dropped": SPAN_RING.dropped,
                       "lost_inside_window": SPAN_RING.lost_until_ns > w0,
                       "spans_in_window": int(len(a["seq"]))}
        out["dtoh"] = dtoh_check(a, names, t.device)
        out["calls"] = calls_check(a, names, p50)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
