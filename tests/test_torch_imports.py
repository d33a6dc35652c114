"""The port stands alone: no module of fastdfs_tpu_torch, and not
chip_smoke.py, imports JAX or anything of the JAX package or names one
of its modules (as ``python -m`` in a subprocess would), and its entry
points refuse CUDA where there is none instead of falling back."""

import ast
import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import fastdfs_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import fastdfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fastdfs_tpu_torch.__path__,
                                               "fastdfs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "fastdfs_tpu" or m.startswith("fastdfs_tpu."))
print(len(names), bad)
"""


def test_no_module_imports_jax_or_the_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 29
    assert bad.strip() == "[]"


def test_no_source_names_a_reference_module():
    """No string in the port's source or chip_smoke.py is a module name
    of the JAX package (an argv item of ``python -m fastdfs_tpu.cli``, a
    name for importlib) or a ``-m fastdfs_tpu.`` command line."""
    paths = glob.glob(os.path.join(REPO, "fastdfs_tpu_torch", "**", "*.py"),
                      recursive=True)
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    named = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and (node.value.startswith("fastdfs_tpu.")
                         or re.search(r"-m\s+fastdfs_tpu\.", node.value))):
                named.append(f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert len(paths) > 30
    assert named == []


def test_every_module_is_listed():
    names = {m.name for m in pkgutil.walk_packages(fastdfs_tpu_torch.__path__,
                                                   "fastdfs_tpu_torch.")}
    for want in ("common.protocol", "ops.sha1", "ops.cuda_sha1", "ops.minhash",
                 "ops.cuda_minhash", "ops._build", "ops.gear_cdc",
                 "ops.gf256", "ops.rs_code", "ops.streaming", "client",
                 "client.fingerprint", "dedup.index", "dedup.engine",
                 "sidecar", "parallel", "parallel.mesh",
                 "parallel.collectives", "parallel.ingest_step", "entry",
                 "tools", "tools.timing", "tools.profile_fingerprint",
                 "common.ini_config", "common.jumphash", "client.conn",
                 "client.tracker_client", "client.storage_client",
                 "client.client", "trace", "common.fileid", "common.mime",
                 "common.http_token", "monitor", "cli", "bench",
                 "bench_configs", "tools.bench_index_scale",
                 "dedup.stage_copy", "tools.stage_copy_rate"):
        assert "fastdfs_tpu_torch." + want in names


def test_every_reference_module_has_a_counterpart():
    """Each module file of the JAX package has one in the port; the two
    Pallas kernels map to the CUDA wrappers (their kernels live under
    ``csrc/``)."""
    kernels = {"ops/pallas_sha1.py": "ops/cuda_sha1.py",
               "ops/pallas_minhash.py": "ops/cuda_minhash.py"}
    ref_root = os.path.join(REPO, "fastdfs_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            rel = kernels.get(rel, rel)
            if not os.path.exists(os.path.join(REPO, "fastdfs_tpu_torch",
                                               rel)):
                missing.append(rel)
    assert missing == []
    for src in ("sha1.cu", "minhash_survivor.cu"):
        assert os.path.exists(os.path.join(REPO, "fastdfs_tpu_torch", "csrc",
                                           src))


def test_sidecar_main_refuses_cuda_without_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from fastdfs_tpu_torch import sidecar

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sidecar.main(["--socket", str(tmp_path / "s.sock")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sidecar.main(["--socket", str(tmp_path / "s.sock"), "--fan-out",
                      "2"])
    # --fan-out on the CPU builds and warms a fanned-out engine.
    served = []
    monkeypatch.setattr(sidecar.DedupSidecar, "serve_forever",
                        lambda self, **kw: served.append(self))
    monkeypatch.setattr(sidecar.signal, "signal", lambda *a: None)
    assert sidecar.main(["--socket", str(tmp_path / "s.sock"), "--platform",
                         "cpu", "--fan-out", "2"]) == 0
    assert served[0].engine.devices == [torch.device("cpu")] * 2


def test_kernel_sources_and_build_are_keyed():
    from fastdfs_tpu_torch.ops import _build

    names = [p.name for p in _build.sources()]
    assert names == ["gear_cdc.cu", "gf_matmul.cu", "host_copy.cu",
                     "index_query.cu", "minhash_sig.cu",
                     "minhash_survivor.cu", "sha1.cu"]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()  # stable key for unchanged sources


def test_client_constructors_refuse_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from fastdfs_tpu_torch.client import FdfsClient, StorageClient

    conf = tmp_path / "client.conf"
    conf.write_text("tracker_server = 127.0.0.1:1\n")
    for make in (lambda: StorageClient("127.0.0.1", 1),
                 lambda: FdfsClient("127.0.0.1:1"),
                 lambda: FdfsClient.from_conf(str(conf))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # On the CPU they build; the storage client connects only then.
    assert FdfsClient.from_conf(str(conf), device="cpu").device.type == "cpu"
    with pytest.raises(OSError):
        StorageClient("127.0.0.1", 1, timeout=1.0, device="cpu")
