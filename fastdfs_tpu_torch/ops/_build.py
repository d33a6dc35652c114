"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (one of
them, ``host_copy.cu``, holds host code only: the engine's staging copy).  One
``nvcc`` per source runs in parallel, then one link.  The library lands
in ``fastdfs_tpu_torch/_build/`` under a name keyed on a hash of the
sources and flags, so a checkout builds on its first kernel call and
reuses the result afterwards; a source edit builds anew.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_CFLAGS = ["-O3", "-std=c++17", _ARCH, "-Xptxas=-v", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_SIGNATURES = {
    # seg, offsets, lens, order, n, out, out_stride, stream
    "fdfs_sha1_ragged": [_VP, _VP, _VP, _VP, ctypes.c_int, _VP,
                         ctypes.c_longlong, _VP],
    # seg, offsets, lens, order, perms, n, sig, sig_stride, z, stream
    "fdfs_sketch_ragged": [_VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP,
                           ctypes.c_longlong, _VP, _VP],
    # data, len, n, avg_bits, k, out, scratch, stream
    "fdfs_gear_candidates": [_VP, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_longlong, _VP, _VP, _VP],
    # rows, row_stride, b, L, halo, avg_bits, out, stream
    "fdfs_gear_block_mask": [_VP, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, _VP, ctypes.c_int, _VP, _VP],
    # sigs, index, n, m, p, sms, best, stream
    "fdfs_index_best": [_VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, _VP, _VP],
    # table, matrix, rows, k, shards, shard_stride, L, out, out_stride, stream
    "fdfs_gf_matmul": [_VP, _VP, ctypes.c_int, ctypes.c_int, _VP,
                       ctypes.c_longlong, ctypes.c_longlong, _VP,
                       ctypes.c_longlong, _VP],
    # z, z_stride, n, words, p, sig, sig_stride, stream
    "fdfs_minhash_sig": [_VP, ctypes.c_longlong, ctypes.c_int, _VP,
                         ctypes.c_int, _VP, ctypes.c_longlong, _VP],
    # seg, offsets, lens, order, perms, n, k, poly_bk, sig, sig_stride, z,
    # stream
    "fdfs_sketch_ragged_k": [_VP, _VP, _VP, _VP, _VP, ctypes.c_int,
                             ctypes.c_int, ctypes.c_uint, _VP,
                             ctypes.c_longlong, _VP, _VP],
    # dst, src, n, step, threads (host only: the engine's staging copy)
    "fdfs_host_copy": [_VP, _VP, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdfs_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the sources unless the keyed library exists.  Returns the
    library path, the seconds spent building (0.0 when cached) and the
    compiler's output (ptxas register and spill report)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = []
        procs = []
        for src in sources():
            obj = os.path.join(work, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_CFLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(work, so.name)
        link = subprocess.run([nvcc, _ARCH, "-shared", *objs, "-o", tmp_so],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: concurrent builds race safely
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so, time.monotonic() - t0, "\n".join(logs)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() from a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
