"""The control: the comparison must call it wrong.

    python3 -m portbench.control --workload <config>.<traffic> \\
        --seed <n> --seconds <s>

runs a cell as ``run.py`` does (its pool, its streams, its window, its
check) with the plain reference put in the engine's place and one
guarantee of the configuration broken: the sketch keeps the windows
whose hash has its low 9 bits zero, not 8 (``SAMPLE_MASK`` 0x1FF), which
halves the survivors and stage 4's work, the step that would tempt a
faster sketch.  The digests and spans stay exact.  It prints the numbers
compared and a JSON line; it exits 0 only where the check calls the
control wrong (``correct`` false), as it must.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

from portbench import manifest, reference, run

CONTROL_SAMPLE_MASK = 0x1FF


class ControlEngine:
    """``fingerprint(data, cuts)`` from the reference with the coarser
    sample; each segment's answer is worked out once and served from
    then on, so that the window's calls cost what the check's do."""

    def __init__(self, shingle: int, perms: int,
                 sample_mask: int = CONTROL_SAMPLE_MASK):
        self.shingle = shingle
        self.perms = perms
        self.sample_mask = sample_mask
        self.lock = threading.Lock()
        self.done: dict[int, tuple] = {}
        self.busy: dict[int, threading.Lock] = {}

    def fingerprint(self, data: bytes, cuts):
        key = id(data)
        with self.lock:
            seg_lock = self.busy.setdefault(key, threading.Lock())
        with seg_lock:
            if key not in self.done:
                ans = reference.answer(data, cuts, self.shingle, self.perms,
                                       self.sample_mask)
                spans = list(zip(ans.offsets.tolist(), ans.lens.tolist()))
                self.done[key] = (spans, ans.digests, ans.sigs)
        return self.done[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    cell = manifest.cell(args.workload)
    d = cell.dedup
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    result, lines = run.run_cell(cell, args.seed, args.seconds, False, device,
                                 system=ControlEngine(d["shingle"],
                                                     d["num_perms"]))
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps({"control": "sample_mask 0x1FF",
                      "correct": result["correct"],
                      "attempted": result["attempted"],
                      "checks": result["checks"]}), flush=True)
    return 0 if not result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
