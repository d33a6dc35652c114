"""Find a cell's files by the names in ``BENCHMARK.json``.

- the configuration: the ``file`` its entry names (``configs/<name>.json``);
- the traffic mix: ``traffic/<traffic>.json``: the loop and the segment
  size; how many calls run at once is the deployment's (``Cell.streams``);
- each metric: ``metrics/<name>.py``, a reader that defines ``UNIT``,
  ``LAYER`` (per-layer metrics), ``MOVES`` (per-layer metrics) and
  ``read(run)``, which returns a number or None where it finds nothing
  to read.

A later cell, mix or metric is a new file and a new entry; nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


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


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise ManifestError(f"missing {path}") from e


def load_reader(root: Path, name: str) -> ModuleType:
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no reader for metric {name}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
                [_metric(root, m, True) for m in layer])
