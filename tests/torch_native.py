"""The storage and tracker daemons for the port's live tests,
``chip_smoke.py`` and the port's ``bench_configs``: paths to
``fdfs_storaged`` and ``fdfs_trackerd``, to ``fdfs_codec`` (its
``cdc-bench`` times the daemon's chunker) through ``codec_binary()``,
and to ``fdfs_load`` (the native load driver) through ``load_binary()``.

The checkout's ``native/build/`` serves when it holds both daemons, and
its ``fdfs_load`` when it has one.  Otherwise all four are built with
plain g++ into ``native/build-smoke/`` (gitignored) from the source
lists and link lines of ``tools/build_native_gxx.sh``, with
``-include cstddef``: g++ 12 and later reject ``native/tracker/hotmap.cc``,
which uses ``ptrdiff_t`` without ``<cstddef>``.  One g++ per source, all
started together; about half a minute on 8 cores.  A file lock keeps parallel
test workers from building at once, and a stamp of the sources' hash
lets a later call reuse the build.

This module returns paths and assigns nothing in ``tests/harness.py``:
the reference's suites keep their own binaries.  ``start_tracker`` and
``start_storage`` start a daemon from an explicit binary with the
harness's configs.  ``chip_smoke.py`` loads this file by its path (a
host may have another package named ``tests``), and this file loads
``tests/harness.py`` the same way.

It also holds the inputs that the port's tests and ``chip_smoke.py``
share: for the gear CDC ``plant_candidate``, ``seam_plants``,
``plant_wide``, ``wide_seam_plants`` and ``dense_pair``; for the sketch
at other shingle widths ``shingle_segment``; and ``same_keys``, which
holds a benchmark artifact's keys to a reference artifact's.
"""

from __future__ import annotations

import fcntl
import glob
import hashlib
import importlib.util
import os
import re
import subprocess
import time

import numpy as np

from fastdfs_tpu_torch.ops.cuda_gear import RUN, TILE
from fastdfs_tpu_torch.ops.gear_cdc import GEAR_TABLE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
GXX_SCRIPT = os.path.join(REPO, "tools", "build_native_gxx.sh")
SMOKE_BUILD = os.path.join(NATIVE, "build-smoke")
FLAGS = ("-std=c++17", "-O2", "-I.", "-include", "cstddef")
OUTPUTS = ("fdfs_storaged", "fdfs_trackerd", "fdfs_codec", "fdfs_load")


def _load_harness():
    path = os.path.join(REPO, "tests", "harness.py")
    spec = importlib.util.spec_from_file_location("fdfs_live_harness", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


harness = _load_harness()


def _sources() -> dict[str, list[str]]:
    """The ``srcs_common``, ``srcs_storage`` and ``srcs_tracker`` lists of
    the g++ build script."""
    with open(GXX_SCRIPT) as fh:
        script = fh.read()
    out = {}
    for var in ("srcs_common", "srcs_storage", "srcs_tracker"):
        m = re.search(var + r'="([^"]*)"', script)
        if m is None:
            raise RuntimeError(f"{GXX_SCRIPT} lists no {var}")
        out[var] = m.group(1).split()
    return out


def _stamp() -> str:
    """A hash of every native source and header, of the flags and of the
    binaries built."""
    h = hashlib.sha256(" ".join(FLAGS + OUTPUTS).encode())
    for path in sorted(glob.glob(os.path.join(NATIVE, "*", "*.[ch]*"))):
        if os.path.isfile(path):
            h.update(os.path.relpath(path, NATIVE).encode())
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _obj(src: str) -> str:
    return os.path.join(SMOKE_BUILD, src.replace("/", "_")[:-3] + ".o")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in ``native/`` together; raise on the first that
    fails, with its output."""
    procs = [(subprocess.Popen(cmd, cwd=NATIVE, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT), cmd)
             for cmd in cmds]
    failed = []
    for proc, cmd in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log[-2000:]}")
    if failed:
        raise RuntimeError("native build failed:\n" + failed[0])


def _build() -> None:
    srcs = _sources()
    compile_all = [["g++", *FLAGS, "-c", src, "-o", _obj(src)]
                   for srcs_of in srcs.values() for src in srcs_of]
    compile_all.append(["g++", *FLAGS, "-msha", "-mssse3", "-msse4.1", "-c",
                        "common/sha1_ni.cc", "-o",
                        _obj("common/sha1_ni.cc")])
    _run(compile_all)
    common = os.path.join(SMOKE_BUILD, "libfdfs_common.a")
    storage = os.path.join(SMOKE_BUILD, "libfdfs_storage.a")
    tracker = os.path.join(SMOKE_BUILD, "libfdfs_tracker.a")
    common_objs = [_obj(s) for s in srcs["srcs_common"]]
    common_objs.append(_obj("common/sha1_ni.cc"))
    for lib, objs in ((common, common_objs),
                      (storage, [_obj(s) for s in srcs["srcs_storage"]]),
                      (tracker, [_obj(s) for s in srcs["srcs_tracker"]])):
        if os.path.exists(lib):
            os.unlink(lib)
        _run([["ar", "rcs", lib, *objs]])
    # -rdynamic as in the script: the daemons' profiler symbolizes frames
    # through the dynamic symbol table.
    link = ["g++", *FLAGS, "-rdynamic"]
    _run([[*link, "storage/main.cc", storage, common, "-lpthread", "-o",
           os.path.join(SMOKE_BUILD, "fdfs_storaged")],
          [*link, "tracker/main.cc", tracker,
           _obj("storage/admission.cc"), common, "-lpthread", "-o",
           os.path.join(SMOKE_BUILD, "fdfs_trackerd")],
          [*link, "tools/codec_cli.cc",
           *(_obj(src) for src in ("storage/slabstore.cc",
                                   "storage/ecstore.cc",
                                   "storage/admission.cc",
                                   "tracker/placement.cc",
                                   "tracker/cluster.cc",
                                   "tracker/hotmap.cc")),
           common, "-lpthread", "-o",
           os.path.join(SMOKE_BUILD, "fdfs_codec")],
          [*link, "tools/load_cli.cc", common, "-lpthread", "-o",
           os.path.join(SMOKE_BUILD, "fdfs_load")]])


def _smoke_build() -> tuple[list[str], float]:
    """The smoke build's ``OUTPUTS`` and the seconds spent on them: built
    or rebuilt under a file lock when its stamp is stale."""
    t0 = time.monotonic()
    os.makedirs(SMOKE_BUILD, exist_ok=True)
    outputs = [os.path.join(SMOKE_BUILD, name) for name in OUTPUTS]
    stamp_path = os.path.join(SMOKE_BUILD, "stamp")
    with open(os.path.join(SMOKE_BUILD, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        want = _stamp()
        try:
            with open(stamp_path) as fh:
                fresh = fh.read() == want
        except OSError:
            fresh = False
        if not (fresh and all(os.path.exists(p) for p in outputs)):
            if os.path.exists(stamp_path):
                os.unlink(stamp_path)
            _build()
            with open(stamp_path, "w") as fh:
                fh.write(want)
    return outputs, time.monotonic() - t0


def native_binaries() -> tuple[str, str, float]:
    """``(fdfs_storaged, fdfs_trackerd, seconds spent building)``: the
    checkout's ``native/build/`` pair when it has both, else the smoke
    build's."""
    built = os.path.join(NATIVE, "build")
    pair = (os.path.join(built, "fdfs_storaged"),
            os.path.join(built, "fdfs_trackerd"))
    if all(os.path.exists(p) for p in pair):
        return pair[0], pair[1], 0.0
    outputs, seconds = _smoke_build()
    return outputs[0], outputs[1], seconds


def codec_binary() -> str | None:
    """``fdfs_codec`` beside the daemons ``native_binaries()`` gives: the
    smoke build always has it, a checkout's ``native/build/`` may not
    (then None)."""
    storaged = native_binaries()[0]
    path = os.path.join(os.path.dirname(storaged), "fdfs_codec")
    return path if os.path.exists(path) else None


def load_binary() -> str:
    """``fdfs_load``, the native load driver (``tools/load_cli.cc``): the
    checkout's ``native/build/fdfs_load`` when it is there, else the
    smoke build's."""
    path = os.path.join(NATIVE, "build", "fdfs_load")
    if os.path.exists(path):
        return path
    return _smoke_build()[0][OUTPUTS.index("fdfs_load")]


def start_tracker(trackerd: str, base: str, **kw):
    """``fdfs_trackerd`` on a free localhost port, its base dir ``base``;
    ``kw`` goes to ``harness.make_tracker_conf``."""
    os.makedirs(base, exist_ok=True)
    port = harness.free_port()
    return harness.Daemon(trackerd, harness.make_tracker_conf(base, port,
                                                              **kw), port)


def start_storage(storaged: str, base: str, ip: str = "127.0.0.1",
                  port: int | None = None, **kw):
    """``fdfs_storaged`` on ``ip`` and a free (or the given) port, its
    base dir ``base``; ``kw`` goes to ``harness.make_storage_conf``."""
    os.makedirs(base, exist_ok=True)
    port = port or harness.free_port()
    conf = harness.make_storage_conf(base, port, ip=ip, **kw)
    return harness.Daemon(storaged, conf, port, ip=ip)


def plant_candidate(buf: np.ndarray, p: int, avg_bits: int) -> None:
    """Set ``buf[p - 1]`` and ``buf[p]`` so that position ``p`` is a cut
    candidate of the whole stream: the low ``avg_bits`` bits of the gear
    hash at ``p`` depend only on its last ``avg_bits`` bytes.  Planting in
    increasing order keeps earlier plants two or more apart intact."""
    g = GEAR_TABLE.astype(np.int64)
    rest = sum(int(g[buf[p - k]]) << k for k in range(2, avg_bits)
               if p - k >= 0)
    low = (g[:, None] + (g[None, :] << 1) + rest) & ((1 << avg_bits) - 1)
    buf[p], buf[p - 1] = np.argwhere(low == 0)[0]


def seam_plants(size: int) -> list[int]:
    """Positions in the first window and on both sides of the gear
    kernel's thread-run and tile seams (``cuda_gear.RUN``, ``TILE``)
    below ``size``, in increasing order and two or more apart."""
    planted = list(range(1, 32, 2))
    for j in range(1, 9):
        planted += [RUN * j - 1, RUN * j + 1]
    for j in range(1, size // TILE + 1):
        planted += [TILE * j + d for d in (-3, -1, 1, 3)]
    return sorted(p for p in set(planted) if p < size)


def plant_wide(buf: np.ndarray, p: int, avg_bits: int) -> None:
    """Set ``buf[p - avg_bits + 1 .. p]`` so that position ``p`` is a cut
    candidate at any ``avg_bits`` (``p >= avg_bits - 1``): bit j of the
    hash at ``p`` is bit j of the terms of the j bytes after
    ``buf[p - j]`` plus the low bit of that byte's gear value, so one
    byte a bit, from bit 0 up, clears them all.  Planting in increasing
    order keeps earlier plants ``avg_bits`` or more apart intact."""
    g = GEAR_TABLE.astype(np.int64)
    parity = [np.flatnonzero(g & 1 == b) for b in (0, 1)]
    h = 0
    for j in range(avg_bits):
        x = int(parity[(h >> j) & 1][(p + j) % len(parity[0])])
        buf[p - j] = x
        h += int(g[x]) << j
    assert h & ((1 << avg_bits) - 1) == 0


def wide_seam_plants(size: int, avg_bits: int) -> list[int]:
    """Positions for ``plant_wide`` below ``size``, ``avg_bits`` or more
    apart: the first window's last position, the first positions of
    thread runs (whose windows reach back into the bytes a thread rolls
    before its run) and both sides of each tile seam."""
    planted = [avg_bits - 1]
    for j in range(1, 9):
        planted.append(RUN * j + (0, 1, 5, -1)[j % 4])
    for j in range(1, size // TILE + 1):
        planted += [TILE * j - (j % 2), TILE * j + 33]
    return sorted(p for p in planted if p < size)


def dense_pair(avg_bits: int) -> tuple[int, int]:
    """Bytes (x, y) whose run x y x y ... makes every y a cut candidate:
    the hash at a y is g(y) * S + g(x) * 2S with S = sum of 4**j, j < 16."""
    g = GEAR_TABLE.astype(np.uint64)
    s = np.uint64(0x55555555)
    h = (g[None, :] * s + g[:, None] * (s << np.uint64(1))) & np.uint64(
        0xFFFFFFFF)
    xs, ys = np.nonzero((h & np.uint64((1 << avg_bits) - 1)) == 0)
    return int(xs[0]), int(ys[0])


def shingle_segment(rng: np.random.Generator, k: int
                    ) -> tuple[bytes, list[int], list[int]]:
    """(segment, offsets, lengths) for stages 1-3 at shingle width k:
    lengths 0, 1, k - 1, k, k + 1 and a few hundred at every start
    offset mod 4, each followed by non-zero bytes, then a chunk of three
    of the general kernel's 4096-position passes and a tail."""
    seg = bytearray()
    offsets, lens = [], []
    for align in range(4):
        for n in sorted({0, 1, k - 1, k, k + 1, 300 + k}) + (
                [3 * 4096 + 77] if align == 3 else []):
            seg += rng.integers(1, 256, 1 + (align - len(seg) - 1) % 4,
                                dtype=np.uint8).tobytes()
            offsets.append(len(seg))
            lens.append(n)
            seg += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(seg), offsets, lens


def same_keys(got, want, added=frozenset(), added_in="", path=""):
    """Assert that ``got`` has ``want``'s dict keys at every level (a
    list of dicts by its first item), and ``added`` besides in each dict
    whose path ends with ``added_in``, a suffix or a tuple of them
    (``/arms/reactors1/preload`` ends with ``/preload``)."""
    if isinstance(want, dict):
        extra = set(added) if added_in and path.endswith(added_in) else set()
        assert set(got) == set(want) | extra, path
        for key in want:
            same_keys(got[key], want[key], added, added_in, f"{path}/{key}")
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(got) == len(want), path
        same_keys(got[0], want[0], added, added_in, f"{path}[0]")


if __name__ == "__main__":
    storaged, trackerd, seconds = native_binaries()
    print(f"{storaged}\n{trackerd}\n{codec_binary()}\n{load_binary()}\n"
          f"built in {seconds:.1f} s")
