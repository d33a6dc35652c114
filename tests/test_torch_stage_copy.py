"""The engine's sliced staging copy (``fastdfs_tpu_torch.dedup.stage_copy``)
on the CPU, as the engine calls it.

The copy's pool is ``csrc/host_copy.cu``'s C++ threads, which an engine
on a card calls through the kernel library; here the source is built
with the host's C++ compiler (it holds host code only) and handed to the
engine in place of the library.  The copy must give the source's bytes
whatever the length, the slicing and the callers at once; the engine
zeroes the slack after it and counts how each call was copied; its
answers are the inline path's and hashlib's.  An engine on the CPU, which
has no kernel library, copies every segment inline.

Tolerance: exact equality of every byte, digest and signature.
"""

import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fastdfs_tpu_torch.dedup import DedupConfig, DedupEngine
from fastdfs_tpu_torch.dedup import engine as engine_mod
from fastdfs_tpu_torch.dedup import stage_copy
from fastdfs_tpu_torch.ops import SEGMENT_SLACK, _build
from fastdfs_tpu_torch.tools import stage_copy_rate

GEO = dict(min_size=64, avg_bits=8, max_size=1024, row_tile=32)
S = stage_copy._SLICE_MIN
LENGTHS = [0, 1, S - 1, S, S + 1, 2 * S - 1, 2 * S, 2 * S + 1,
           (64 << 20) + 7]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """``fdfs_host_copy`` from ``csrc/host_copy.cu``, built with g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/host_copy.cu")
    so = tmp_path_factory.mktemp("host_copy") / "libhost_copy.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
                    "-x", "c++", str(_build.CSRC / "host_copy.cu"), "-o",
                    str(so)], check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(so)).fdfs_host_copy
    fn.argtypes = _build._SIGNATURES["fdfs_host_copy"]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture
def four_copiers(monkeypatch):
    """Four copiers whatever the host's CPUs, so the pool always slices."""
    monkeypatch.setattr(stage_copy, "_copiers", lambda: 4)


@pytest.fixture
def fresh_copiers():
    """Let a test change what ``_copiers`` sees; the next reads anew."""
    stage_copy._copiers.cache_clear()
    yield
    stage_copy._copiers.cache_clear()


def _source(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.frombuffer(rng.integers(0, 256, n, np.uint8).tobytes(),
                         np.uint8)


def _slices(n: int) -> int:
    step = stage_copy.slice_bytes(n)
    return -(-n // step) if step else 1


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("copiers", [2, 4])
def test_copy_gives_the_source_bytes(native, monkeypatch, copiers, n):
    monkeypatch.setattr(stage_copy, "_copiers", lambda: copiers)
    src = _source(n, n)
    dst = np.full(n + 64, 0xAB, np.uint8)
    slices, pooled = stage_copy.copy(dst, src, native)
    assert np.array_equal(dst[:n], src)
    assert (dst[n:] == 0xAB).all()
    assert (slices > 1) == (n >= 2 * S)
    assert slices == _slices(n)
    assert slices <= copiers
    assert 0 <= pooled <= slices if slices > 1 else pooled == 0


def test_native_copy_refuses_what_it_cannot_copy(native, four_copiers):
    src = _source(2 * S)
    for dst in (np.zeros(2 * S - 1, np.uint8), np.zeros(4 * S, np.uint8)[::2],
                np.zeros(2 * S, np.int16)):
        with pytest.raises(ValueError, match="contiguous uint8"):
            stage_copy.copy(dst, src, native)


def test_slices_are_aligned_and_cover_the_segment(four_copiers):
    for n in (2 * S - 1, 2 * S, 3 * S + 7, (64 << 20) + 7, 1 << 30):
        step = stage_copy.slice_bytes(n)
        k = -(-n // step) if step else 1
        if n < 2 * S:
            assert step == 0
            continue
        assert step % stage_copy._ALIGN == 0
        assert 2 <= k <= min(4, n // S)
        assert (k - 1) * step < n <= k * step


def test_callers_at_once_each_get_their_own_bytes(native, four_copiers):
    srcs = [_source(3 * S + 4096 * c + c, 100 + c) for c in range(4)]
    dsts = [np.zeros(len(srcs[-1]) + 16, np.uint8) for _ in srcs]
    wrong = []

    def caller(c):
        for r in range(3):
            src = srcs[(c + r) % 4]
            try:
                stage_copy.copy(dsts[c], src, native)
            except Exception as e:  # noqa: BLE001  reported below
                wrong.append((c, r, repr(e)))
            if not np.array_equal(dsts[c][:len(src)], src):
                wrong.append((c, r))

    threads = [threading.Thread(target=caller, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []


def test_one_cpu_copies_inline(monkeypatch, fresh_copiers, native):
    monkeypatch.setattr(stage_copy.os, "sched_getaffinity", lambda pid: {0})
    src = _source(4 * S, 9)
    dst = np.zeros(len(src), np.uint8)
    assert stage_copy.copy(dst, src, native) == (1, 0)
    assert np.array_equal(dst, src)


def test_without_the_library_copies_inline(four_copiers):
    assert stage_copy.native_copy(torch.device("cpu")) is None
    src = _source(4 * S, 10)
    dst = np.zeros(len(src), np.uint8)
    assert stage_copy.copy(dst, src, None) == (1, 0)
    assert np.array_equal(dst, src)


def _small_slices(monkeypatch, native):
    # An engine on the CPU copying as an engine on a card does, in slices
    # of 4 KiB, so that a segment the plain twins hash in a second is cut
    # into as many slices as there are copiers.
    monkeypatch.setattr(stage_copy, "native_copy", lambda device: native)
    monkeypatch.setattr(stage_copy, "_SLICE_MIN", 4096)


def _cuts(n: int) -> list[int]:
    return [*range(1000, n, 1000), n]


def test_engine_sliced_matches_inline_and_hashlib(monkeypatch, four_copiers,
                                                  native):
    data = _source(48_000, 11).tobytes()
    inline = DedupEngine(DedupConfig(**GEO), device="cpu").fingerprint(data)
    _small_slices(monkeypatch, native)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    spans, digests, sigs = eng.fingerprint(data)
    assert eng.stage_counts["stage_sliced"] == 1
    assert spans == inline[0]
    assert np.array_equal(digests, inline[1])
    assert np.array_equal(sigs, inline[2])
    raw = digests.astype(">u4").tobytes()
    for i, (off, ln) in enumerate(spans):
        assert raw[i * 20:(i + 1) * 20] == hashlib.sha1(
            data[off:off + ln]).digest()


def test_engine_on_the_cpu_copies_inline(monkeypatch, four_copiers):
    monkeypatch.setattr(stage_copy, "_SLICE_MIN", 4096)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    data = _source(32_768, 15).tobytes()
    for _ in range(2):
        eng.fingerprint(data, cuts=_cuts(len(data)))
    assert eng.stage_counts == {"stage_sliced": 0, "stage_inline": 2,
                                "stage_pool_slices": 0}
    staged = eng._thread().seg.numpy()
    assert np.array_equal(staged[:len(data)], np.frombuffer(data, np.uint8))


def test_engine_zeroes_the_slack_after_a_longer_call(monkeypatch,
                                                     four_copiers, native):
    _small_slices(monkeypatch, native)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    long = _source(40_000, 12).tobytes()
    short = _source(20_001, 13).tobytes()
    eng.fingerprint(long, cuts=_cuts(len(long)))
    staged = eng._thread().seg.numpy()
    assert staged[20_001:40_000].any()          # dirty from the long call
    eng.fingerprint(short, cuts=_cuts(len(short)))
    assert eng.stage_counts["stage_sliced"] == 2
    staged = eng._thread().seg.numpy()
    assert np.array_equal(staged[:len(short)], np.frombuffer(short, np.uint8))
    assert not staged[len(short):len(short) + SEGMENT_SLACK].any()


def _counting(monkeypatch):
    """What every engine call's copy returned, in order."""
    returned = []
    real = stage_copy.copy
    lock = threading.Lock()

    def counted(dst, src, native):
        got = real(dst, src, native)
        with lock:
            returned.append(got)
        return got

    monkeypatch.setattr(engine_mod.stage_copy, "copy", counted)
    return returned


def test_engine_counts_how_each_call_was_copied(monkeypatch, four_copiers,
                                                native):
    _small_slices(monkeypatch, native)
    returned = _counting(monkeypatch)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    assert eng.stage_counts == {"stage_sliced": 0, "stage_inline": 0,
                                "stage_pool_slices": 0}
    eng.warmup()                                  # 512 bytes: inline
    data = _source(32_768, 14).tobytes()
    for cuts in (_cuts(len(data)), [100, 9_000, len(data)]):
        eng.fingerprint(data, cuts=cuts)
    eng.fingerprint(data[:5_000], cuts=_cuts(5_000))  # under 2 slices
    eng.fingerprint(b"")                              # no chunk: no copy
    assert [s for s, _ in returned] == [1, _slices(32_768),
                                        _slices(32_768), 1]
    sliced = 2
    assert eng.stage_counts == {
        "stage_sliced": sliced, "stage_inline": len(returned) - sliced,
        "stage_pool_slices": sum(p for _, p in returned)}


def test_rate_tool_reports_the_host_on_the_cpu(tmp_path):
    out = tmp_path / "rate.json"
    assert stage_copy_rate.main(["--mib", "1", "--reps", "2", "--threads",
                                 "1,2", "--callers", "1,2", "--out",
                                 str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["host"]["cpu_count"] >= 1 and got["host"]["affinity"]
    assert set(got["split_copy"]) == {"threads1_callers1", "threads2_callers1",
                                      "threads1_callers2", "threads2_callers2"}
    assert got["route"] is None and got["device"] is None
    assert got["card"] is None and got["pinned"] is False
    assert got["route_params"]["slice_bytes"] == 0    # 1 MiB: inline


def test_counters_hold_under_many_threads(monkeypatch, four_copiers, native):
    """More callers than cores, switching threads as often as the
    interpreter can: every call is counted once, every pool slice once,
    and every call's answer is hashlib's."""
    _small_slices(monkeypatch, native)
    monkeypatch.setattr(stage_copy, "_SLICE_MIN", 1024)
    returned = _counting(monkeypatch)
    eng = DedupEngine(DedupConfig(**GEO), device="cpu")
    datas = [_source(3000 + 5000 * (c % 2), 200 + c).tobytes()
             for c in range(12)]
    wrong = []

    def caller(c):
        for r in range(2):
            data = datas[(c + r) % 12]
            spans, digests, _ = eng.fingerprint(data, cuts=_cuts(len(data)))
            raw = digests.astype(">u4").tobytes()
            if any(raw[i * 20:(i + 1) * 20]
                   != hashlib.sha1(data[o:o + n]).digest()
                   for i, (o, n) in enumerate(spans)):
                wrong.append((c, r))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=caller, args=(c,))
                   for c in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert wrong == [] and len(returned) == 24
    sliced = sum(s > 1 for s, _ in returned)
    assert sliced == 12
    assert eng.stage_counts == {
        "stage_sliced": sliced, "stage_inline": 24 - sliced,
        "stage_pool_slices": sum(p for _, p in returned)}
