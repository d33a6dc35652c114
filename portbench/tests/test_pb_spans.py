"""The readers of the engine's spans on hand-made runs: spans written
into a fresh span ring by hand, laid over a hand-built device trace,
each reader's value worked out by hand; and each finds nothing to read
without a trace, where the ring lost spans inside the window, without
the program's ring, and (those that lay spans over device operations)
without a copy or with a copy off the ring's clock."""

import numpy as np
import pytest

import fastdfs_tpu_torch.trace as program_trace
from portbench import manifest, spans
from portbench.trace import Trace

U = 1000   # one microsecond, in the traces' nanoseconds
WINDOW = (100 * U, 200 * U)
STAGES = ["engine.stage_wait", "engine.stage_copy", "engine.table",
          "engine.upload", "engine.launch", "engine.copy_back",
          "engine.unpack"]
# Two calls: root (start, end), then the children's boundaries, in us.
CALLS = [((110, 150), [111, 112, 120, 121, 122, 124, 140, 145]),
         ((150, 190), [151, 152, 164, 165, 166, 168, 180, 182])]
DTOH_A = ("Memcpy DtoH (Device -> Pageable)", 128 * U, 130 * U)
DTOH_B = ("Memcpy DtoH (Device -> Pageable)", 170 * U, 171 * U)
OTHER = [("Memcpy HtoD (Pinned -> Device)", 122 * U, 123 * U),
         ("sha1_ragged_kernel", 123 * U, 125 * U),
         ("sketch_ragged_kernel", 132 * U, 134 * U),
         ("Memcpy HtoD (Pinned -> Device)", 166 * U, 167 * U),
         ("sha1_ragged_kernel", 167 * U, 169 * U)]
NAMES = ["engine.stage_copy_ms", "engine.copy_back_ms",
         "engine.copy_back_host_ms", "engine.unpack_ms",
         "device.idle_stage_copy_pct", "device.idle_copy_back_pct"]
MATCHING = {"engine.copy_back_host_ms", "device.idle_copy_back_pct"}
# The readers that lay spans over device operations, and so read only
# where the copy backs show them on the ring's clock.
ALIGNED = MATCHING | {"device.idle_stage_copy_pct"}
# Busy: 122-125, 128-130, 132-134, 166-169, 170-171: 11 us of 100.
IDLE_US = 89
WANT = {"engine.stage_copy_ms": 0.010,         # median of 8 and 12 us
        "engine.copy_back_ms": 0.014,          # of 16 and 12
        "engine.copy_back_host_ms": 0.0095,    # 140 - 130, 180 - 171
        "engine.unpack_ms": 0.0035,            # of 5 and 2
        # 112-120 and 152-164, all idle.
        "device.idle_stage_copy_pct": 100 * 20 / IDLE_US,
        # 130-140 (2 us of it the sketch) and 171-180.
        "device.idle_copy_back_pct": 100 * (10 - 2 + 9) / IDLE_US}


class HandRun:
    def __init__(self, trace):
        self.trace = trace


def ring_with(calls, capacity=1 << 10):
    ring = program_trace.SpanRing(capacity)
    rec = program_trace.CallSpans(ring, "engine.fingerprint")
    names = [ring.code(n) for n in STAGES] + [rec.root]
    q = program_trace.array.array
    for (t0, t1), bounds in calls:
        ring._record(q("q", [b * U for b in bounds[:-1]] + [t0 * U]),
                     q("q", [b * U for b in bounds[1:]] + [t1 * U]),
                     q("h", names), rec.tids)
    return ring


def hand_run(device=(DTOH_A, DTOH_B, *OTHER)):
    return HandRun(Trace(list(device), [], WINDOW))


@pytest.fixture
def ring(monkeypatch):
    ring = ring_with(CALLS)
    monkeypatch.setattr(program_trace, "SPAN_RING", ring)
    return ring


def reader(name):
    return manifest.load_reader(manifest.ROOT, name)


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_its_value_by_hand(ring, name):
    assert reader(name).read(hand_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_needs_a_trace(ring, name):
    assert reader(name).read(HandRun(None)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_refuses_a_window_the_ring_lost_spans_of(monkeypatch, name):
    # Eight slots: the first call's eight spans are overwritten by the
    # second's, and they ended inside the window.
    ring = ring_with(CALLS, capacity=8)
    assert ring.dropped == 8 and ring.lost_until_ns == 150 * U
    monkeypatch.setattr(program_trace, "SPAN_RING", ring)
    assert reader(name).read(hand_run()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_a_ring_that_lost_spans_before_the_window(monkeypatch,
                                                               name):
    early = [((t0 - 100, t1 - 100), [b - 100 for b in bounds])
             for (t0, t1), bounds in CALLS]
    ring = ring_with(early + CALLS, capacity=16)
    assert ring.dropped == 16 and ring.lost_until_ns == 90 * U
    monkeypatch.setattr(program_trace, "SPAN_RING", ring)
    assert reader(name).read(hand_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_needs_the_programs_ring(monkeypatch, name):
    monkeypatch.delattr(program_trace, "SPAN_RING")
    assert reader(name).read(hand_run()) is None


@pytest.mark.parametrize("name", sorted(ALIGNED))
def test_reader_needs_a_matching_copy(ring, name):
    assert reader(name).read(hand_run(OTHER)) is None
    # One copy back of two matched: half is enough.
    half = reader(name).read(hand_run((DTOH_A, *OTHER)))
    assert half == pytest.approx(
        {"engine.copy_back_host_ms": 0.010,
         "device.idle_copy_back_pct": 100 * (10 - 2) / (IDLE_US + 1),
         "device.idle_stage_copy_pct": 100 * 20 / (IDLE_US + 1)}[name])


@pytest.mark.parametrize("name", sorted(ALIGNED))
def test_reader_refuses_a_copy_off_the_rings_clock(ring, name):
    """The first call's copy back runs from 124 us: a copy of its own
    that starts 21 us before it shows device time off the ring's clock;
    20 us is the slack."""
    for start, reads in ((103, False), (104, True)):
        early = ("Memcpy DtoH (Device -> Pageable)", start * U, 130 * U)
        got = reader(name).read(hand_run((early, DTOH_B, *OTHER)))
        assert (got is not None) == reads
        if reads and name == "engine.copy_back_host_ms":
            assert got == pytest.approx(WANT[name])


def test_a_copy_that_ends_outside_the_span_is_not_its_own(ring):
    late = ("Memcpy DtoH (Device -> Pageable)", 139 * U, 141 * U)
    run = hand_run((late, DTOH_B, *OTHER))
    got = spans.window_spans(run)
    *_, hit = got.copy_backs()
    assert hit.tolist() == [False, True]
    assert reader("engine.copy_back_host_ms").read(run) == pytest.approx(
        0.009)


def test_interval_arithmetic():
    s, e = spans.merge([5, 1, 2, 10], [6, 3, 4, 12])
    assert s.tolist() == [1, 5, 10] and e.tolist() == [4, 6, 12]
    assert spans.overlap(np.array([0, 5]), np.array([3, 11]), s, e) == \
        2 + 1 + 1
    assert spans.overlap(np.array([0]), np.array([1]), s[:0], e[:0]) == 0


@pytest.mark.parametrize("name", NAMES)
def test_reader_needs_the_cards_operations(ring, name):
    assert reader(name).read(hand_run(())) is None


@pytest.mark.parametrize("cell", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_both_cells_report_the_span_metrics(cell):
    """Both cells report the spans' own durations; the readings laid over
    device operations wait until the benchmark places those on the
    ring's clock in every run."""
    got = {m.name: m.entry for m in manifest.cell(cell).per_layer}
    for name in NAMES:
        if name in ALIGNED:
            assert name not in got
            continue
        entry = got[name]
        assert entry["moves"] == "ingest_GBps"
        assert entry["source"] == "host_clock"
