"""What the benchmark's processes load, by whole top-level names: the
run loads neither JAX nor the JAX package (``fastdfs_tpu_torch`` passes,
``fastdfs_tpu`` does not), and the reference loads nothing of the
program."""

import json
import subprocess
import sys

import pytest

from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "fastdfs_tpu"}


def loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_run_loads_no_jax():
    names = loaded(
        "import portbench.run as r, portbench.trace, portbench.roofline, "
        "portbench.control\n"
        "from portbench import manifest\n"
        "import fastdfs_tpu_torch.dedup.engine\n"
        "for w in ('node_text_cdc.seg64', 'group_bin_sha1.seg64'):\n"
        "    manifest.cell(w)\n"
        "from torch.profiler import profile")
    assert "fastdfs_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import portbench.reference, portbench.check, "
                   "portbench.cdc, portbench.corpus")
    assert "fastdfs_tpu_torch" not in names
    assert "torch" not in names
    assert not names & FORBIDDEN


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "fastdfs_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not set(run.forbidden_modules()) & {"fastdfs_tpu_torchx",
                                               "jaxtyping"}
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in run.forbidden_modules()


def workloads() -> list[str]:
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.parametrize("name", workloads())
def test_each_calls_reference_loads_nothing_of_the_program(name):
    """The plain answer of the cell's call for an item of its pool, made
    and prepared on the CPU, in a process that never loads the program or
    JAX."""
    names = loaded(
        "from portbench import manifest, run\n"
        f"cell = manifest.cell({name!r})\n"
        "cell.traffic = dict(cell.traffic, segment_bytes=1 << 20)\n"
        "cell.config = dict(cell.config, corpus_bytes=1 << 20)\n"
        "item = run.make_pool(cell, 7, 'cpu', lambda msg: None)[0]\n"
        "assert len(cell.call.reference(item, cell).digests)")
    assert "fastdfs_tpu_torch" not in names
    assert not names & FORBIDDEN
