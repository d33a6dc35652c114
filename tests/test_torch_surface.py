"""Every public name of the JAX package's modules is public in the port.

For each module pair that tests/test_torch_imports.py walks (each module
file of ``fastdfs_tpu/`` and its counterpart in ``fastdfs_tpu_torch/``,
the two Pallas files mapped to their CUDA wrappers), every public name of
the reference module (not a module object, not ``from __future__``) is
public in the port module, or stands on the allow-list below with its
reason.  A ``*_pallas`` name is looked for as ``*_cuda``.  Importing the
reference modules compiles nothing on XLA.
"""

import importlib
import os
import types
import __future__

import pytest

import fastdfs_tpu  # noqa: F401  (the reference, on the CPU via conftest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"ops/pallas_sha1.py": "ops/cuda_sha1.py",
           "ops/pallas_minhash.py": "ops/cuda_minhash.py"}

# Reference names the port does not carry, by reference module file.
ALLOWED = {
    # Incidental imports of the reference: the port's modules import what
    # they use from the modules that define these names.
    "parallel/ingest_step.py": {
        "EMPTY", "GEAR_TABLE", "minhash_batch", "survivor_segmin",
        "P",  # jax.sharding.PartitionSpec; the port's _shard takes tuples
    },
    "dedup/engine.py": {"minhash_batch"},
    "ops/rs_code.py": {"staging_buffer"},
    # The Pallas kernels' TPU tiling, (sublane, lane) = (DEFAULT_SUB,
    # LANE); the CUDA kernels take ragged chunks and have none.
    "ops/pallas_sha1.py": {"DEFAULT_SUB", "LANE"},
    # The same tiling, and imports from ops/minhash.py, where the port
    # keeps them.
    "ops/pallas_minhash.py": {"LANE", "EMPTY", "SAMPLE_MASK",
                              "minhash_signature"},
}


def _pairs() -> list[tuple[str, str]]:
    root = os.path.join(REPO, "fastdfs_tpu")
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                out.append((rel, KERNELS.get(rel, rel)))
    return sorted(out)


def _module(package: str, rel: str):
    name = rel[:-len(".py")].replace(os.sep, ".")
    if name == "__init__":
        name = ""
    elif name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    return importlib.import_module(f"{package}.{name}" if name else package)


def _public(module) -> set[str]:
    return {name for name, value in vars(module).items()
            if not name.startswith("_")
            and not isinstance(value, (types.ModuleType, __future__._Feature))}


@pytest.mark.parametrize("ref_rel,port_rel", _pairs())
def test_public_names_of_the_reference_are_in_the_port(ref_rel, port_rel):
    ref = _public(_module("fastdfs_tpu", ref_rel))
    port = _public(_module("fastdfs_tpu_torch", port_rel))
    missing = {name for name in ref
               if name not in port
               and not (name.endswith("_pallas")
                        and name[:-len("_pallas")] + "_cuda" in port)}
    allowed = ALLOWED.get(ref_rel, set())
    assert missing - allowed == set(), f"{port_rel} lacks these names"
    # The allow-list holds only what is missing.
    assert allowed <= ref and not allowed & port


def test_fingerprint_mesh_from_the_ingest_step_matches_reference():
    from fastdfs_tpu.parallel.ingest_step import fingerprint_mesh as jmesh
    from fastdfs_tpu_torch.parallel import mesh
    from fastdfs_tpu_torch.parallel.ingest_step import fingerprint_mesh

    assert fingerprint_mesh is mesh.fingerprint_mesh
    for n in (1, 2, 4):
        ours = fingerprint_mesh(n, devices=["cpu"] * n)
        assert ours.shape == dict(jmesh(n).shape)
        assert ours.axis_names == jmesh(n).axis_names
