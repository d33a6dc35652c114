"""Find a cell's files by the names in ``BENCHMARK.json``.

- the configuration: the ``file`` its entry names (``configs/<name>.json``);
- its call: ``calls/<call>.py``, where the configuration's optional
  ``"call"`` names it (``fingerprint_cuts`` where it names none): the
  system under test and what the window sends it, and the plain answer
  each call is held to; it defines the names of ``CALL_NAMES``
  (``run.py`` and ``check.py`` say what each does) and may define
  ``notes(run)``, lines a run logs after its check;
- its corpus: ``corpora/<kind>.py``, where the configuration's
  ``corpus.kind`` names it: the generator of the pool's bytes; it defines
  ``setup`` and ``segment`` (``corpus.py``);
- the traffic mix: ``traffic/<traffic>.json``: the loop and the segment
  size; how many calls run at once is the deployment's (``Cell.streams``);
- each metric: ``metrics/<name>.py``, a reader that defines ``UNIT``,
  ``LAYER`` (per-layer metrics), ``MOVES`` (per-layer metrics) and
  ``read(run)``, which returns a number or None where it finds nothing
  to read.

A later cell, configuration, call, corpus, mix or metric is a new file
and a new entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

DEFAULT_CALL = "fingerprint_cuts"
CALL_NAMES = ("make_system", "prepare", "call", "rows", "expected_rows",
              "reference", "compare", "LIMITS", "ROWS_WRONG")
CORPUS_NAMES = ("setup", "segment")
# The sidecar's dedup settings where a configuration sets none.
DEDUP_DEFAULTS = dict(min_size=2048, avg_bits=13, max_size=65536,
                      num_perms=64, shingle=5)


class ManifestError(Exception):
    pass


@dataclass
class Metric:
    name: str
    entry: dict
    reader: ModuleType


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    call: ModuleType
    corpus: ModuleType

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def streams(self) -> int:
        """Concurrent fingerprint calls: each storage's store paths each
        run the daemon's calls on a dio pool of ``disk_writer_threads``."""
        c = self.config
        return (int(c["storages"]) * int(c["store_path_count"])
                * int(c["disk_writer_threads"]))

    @property
    def dedup(self) -> dict:
        """The engine's dedup settings: the configuration's ``dedup`` over
        the sidecar's defaults."""
        return dict(DEDUP_DEFAULTS, **self.config.get("dedup", {}))


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise ManifestError(f"missing {path}") from e


def _load(path: Path, what: str, names: tuple[str, ...] = ()
          ) -> ModuleType:
    """The module of ``path``, which must define ``names``.  It is in
    ``sys.modules`` while it runs, as an imported module is, so that a
    dataclass in it finds its module."""
    if not path.is_file():
        raise ManifestError(f"no {what}: {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}"),
        path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    missing = [n for n in names if not hasattr(mod, n)]
    if missing:
        raise ManifestError(f"{what}: {path} defines no "
                            f"{', '.join(missing)}")
    return mod


def load_reader(root: Path, name: str) -> ModuleType:
    return _load(root / "portbench" / "metrics" / f"{name}.py",
                 f"reader for metric {name}")


def load_call(root: Path, name: str) -> ModuleType:
    path = root / "portbench" / "calls" / f"{name}.py"
    mod = _load(path, f"call {name}", CALL_NAMES)
    if mod.ROWS_WRONG not in mod.LIMITS:
        raise ManifestError(f"call {name}: {path}: ROWS_WRONG "
                            f"{mod.ROWS_WRONG!r} has no limit in LIMITS")
    return mod


def load_corpus(root: Path, kind: str) -> ModuleType:
    return _load(root / "portbench" / "corpora" / f"{kind}.py",
                 f"corpus kind {kind}", CORPUS_NAMES)


def _metric(root: Path, entry: dict, per_layer: bool) -> Metric:
    reader = load_reader(root, entry["name"])
    want = {"UNIT": entry["unit"]}
    if per_layer:
        want.update(LAYER=entry["layer"], MOVES=entry["moves"])
    for key, value in want.items():
        if getattr(reader, key, None) != value:
            raise ManifestError(f"metric {entry['name']}: reader's {key} "
                                f"{getattr(reader, key, None)!r} is not "
                                f"BENCHMARK.json's {value!r}")
    return Metric(entry["name"], entry, reader)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise ManifestError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
    if "streams" in traffic:
        raise ManifestError(f"traffic {entry['traffic']} sets streams; the "
                            f"configuration's dio pools set them")
    if traffic.get("loop") != "closed":
        raise ManifestError(f"traffic {entry['traffic']}: the streams run "
                            f"a closed loop only, not {traffic.get('loop')!r}")

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name, entry, config, traffic,
                [_metric(root, m, False) for m in e2e],
                [_metric(root, m, True) for m in layer],
                load_call(root, config.get("call", DEFAULT_CALL)),
                load_corpus(root, config["corpus"]["kind"]))
