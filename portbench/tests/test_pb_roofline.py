"""The yardstick's arithmetic on hand-counted work: roofline times, the
trace's reduction and the readers that divide one by the other."""

import numpy as np
import pytest

from portbench import manifest, roofline
from portbench.trace import Trace

PEAK = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_sha1_blocks_and_time_by_hand():
    # 55 bytes + 0x80 + 8-byte length fit one block; 56 need two; 120
    # need three.
    lens = np.array([55, 56, 64, 119, 120])
    assert roofline.sha1_blocks(lens).tolist() == [1, 2, 2, 2, 3]
    ops = 10 * 613
    by = (55 + 56 + 64 + 119 + 120 + 5 * 36)
    want = max(ops / PEAK["int32_ops_per_s"], by / PEAK["hbm_bytes_per_s"])
    assert roofline.sha1_seconds(lens, PEAK) == pytest.approx(want)
    assert ops / PEAK["int32_ops_per_s"] > by / PEAK["hbm_bytes_per_s"]


def test_sha1_at_64_mib_is_bound_by_operations():
    lens = np.full(8192, 8192)
    t = roofline.sha1_seconds(lens, PEAK)
    assert t == pytest.approx(8192 * 129 * 613 / (132 * 64 * 1.98e9))
    # The assumed chain: 129 blocks x 80 rounds x 2 x 4 cycles.
    assert roofline.sha1_chain_seconds(lens, PEAK) == pytest.approx(
        129 * 80 * 2 * 4 / 1.98e9)


def test_sketch_time_by_hand():
    lens = np.array([3, 5, 100])
    # Window starts: 3 (shorter than k: its zero-padded windows), 1, 96.
    ops = (3 + 1 + 96) * 6 + 7 * 64 * 2
    by = 108 + 3 * 272
    want = max(ops / PEAK["int32_ops_per_s"], by / PEAK["hbm_bytes_per_s"])
    assert roofline.sketch_seconds(lens, 7, 64, 5, PEAK) == pytest.approx(want)


def hand_trace():
    # Window 0-100 us; device busy 10-30 (two overlapping ops) and 60-70.
    us = 1000
    device = [("Memcpy HtoD (Pinned -> Device)", 10 * us, 25 * us),
              ("(anonymous namespace)::sha1_ragged_kernel(int*)", 20 * us,
               30 * us),
              ("(anonymous namespace)::sha1_ragged_kernel(int*)", 60 * us,
               70 * us),
              ("Memcpy DtoH (Device -> Pageable)", 200 * us, 210 * us)]
    host = [("cudaMemcpyAsync", 35 * us, 55 * us),
            ("aten::copy_", 31 * us, 40 * us)]
    return Trace(device, host, (0, 100 * us))


def test_trace_busy_ops_and_gaps():
    t = hand_trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(30e-6)
    assert t.ops("sha1_ragged_kernel") == (2, pytest.approx(20e-6))
    assert t.ops("HtoD") == (1, pytest.approx(15e-6))
    assert t.device_ops()[0] == ["sha1_ragged_kernel", pytest.approx(20e-6)]
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 30e-6, 10e-6])
    assert gaps[0][0] == "after sha1_ragged_kernel: cudaMemcpyAsync"
    assert gaps[1][0] == "after sha1_ragged_kernel: host outside torch calls"
    assert gaps[2][0] == "after window_start: host outside torch calls"


class FakeSeg:
    def __init__(self, lens):
        self.lens = np.asarray(lens)
        self.cuts = np.cumsum(lens).tolist()
        self.data = bytes(int(self.lens.sum()))


class FakeAnswer:
    survivors = 10


class FakeRun:
    def __init__(self, trace):
        self.trace = trace
        self.peak = PEAK
        self.pool = [FakeSeg([8192] * 4), FakeSeg([65536] * 2)]
        self.segment = np.array([0, 1])
        self.answers = {0: FakeAnswer(), 1: FakeAnswer()}
        self.dedup = {"num_perms": 64, "shingle": 5}


def test_readers_divide_the_roofline_by_the_trace():
    run = FakeRun(hand_trace())
    sha1 = manifest.load_reader(manifest.ROOT, "kernel.sha1_roofline")
    want = (roofline.sha1_seconds(run.pool[0].lens, PEAK)
            + roofline.sha1_seconds(run.pool[1].lens, PEAK)) / 20e-6 * 100
    assert sha1.read(run) == pytest.approx(want)
    idle = manifest.load_reader(manifest.ROOT, "device.idle_pct")
    assert idle.read(run) == pytest.approx(70.0)
    h2d = manifest.load_reader(manifest.ROOT, "engine.h2d_GBps")
    sent = (8192 * 4 + 16 * 4) + (65536 * 2 + 16 * 2)
    # One of the four copies was kept: a quarter of the bytes.
    assert h2d.read(run) == pytest.approx(sent / 4 / 15e-6 / 1e9)
    # No sketch launch in this trace: the reader finds nothing to read.
    sketch = manifest.load_reader(manifest.ROOT, "kernel.sketch_roofline")
    assert sketch.read(run) is None
    run.peak = None
    assert sha1.read(run) is None
