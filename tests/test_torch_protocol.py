"""The port's wire protocol (``fastdfs_tpu_torch/common/protocol.py``)
against the reference (``fastdfs_tpu/common/protocol.py``).

Every opcode and constant the port copies equals the reference's, member
for member; every copied pack/unpack function gives the same bytes,
values and error types on seeded inputs.  Tolerance: exact equality.
"""

import enum

import numpy as np
import pytest

from fastdfs_tpu.common import protocol as R
from fastdfs_tpu_torch.common import protocol as T

SEEDS = (0, 1, 2, 3)

ENUMS = ("TrackerCmd", "StorageCmd", "Status", "StorageStatus",
         "StoreLookup", "StorePathPolicy", "DownloadServer", "PriorityClass")

CONSTANTS = sorted(
    name for name, value in vars(R).items()
    if name.isupper() and not name.startswith("_")
    and isinstance(value, (int, bytes, tuple, str, frozenset, dict)))


def _members(enum_name):
    return [(enum_name, m.name) for m in getattr(R, enum_name)]


@pytest.mark.parametrize("enum_name,member",
                         [p for e in ENUMS for p in _members(e)])
def test_enum_member_equals_reference(enum_name, member):
    ref = getattr(R, enum_name)[member]
    got = getattr(T, enum_name)[member]
    assert int(got) == int(ref)
    assert got.name == ref.name


@pytest.mark.parametrize("enum_name", ENUMS)
def test_enum_has_exactly_the_reference_members(enum_name):
    ref = getattr(R, enum_name)
    got = getattr(T, enum_name)
    assert issubclass(got, enum.IntEnum)
    assert [(m.name, int(m)) for m in got] == [(m.name, int(m)) for m in ref]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_reference(name):
    assert getattr(T, name) == getattr(R, name)


def test_port_copies_everything_but_the_left_out_tables():
    public = {n for n in vars(R) if not n.startswith("_")}
    missing = {n for n in public if not hasattr(T, n)}
    assert missing == set()


def _text(rng, n, alphabet="abcdefghijklmnopqrstuvwxyz0123456789_-"):
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def _cases(rng):
    """(function name, args) pairs for one seed."""
    meta = {_text(rng, int(rng.integers(1, 12))):
            _text(rng, int(rng.integers(0, 20)), "xyz é€0123")
            for _ in range(int(rng.integers(1, 6)))}
    blob = rng.integers(-(1 << 40), 1 << 40, 20).astype(">i8").tobytes()
    return [
        ("pack_header", (int(rng.integers(0, 1 << 62)),
                         int(rng.integers(0, 256)), int(rng.integers(0, 256)))),
        ("unpack_header", (bytes(rng.integers(0, 128, 1).astype(np.uint8))
                           + bytes(rng.integers(0, 256, 9).astype(np.uint8)),)),
        ("long2buff", (int(rng.integers(-(1 << 62), 1 << 62)),)),
        ("buff2long", (blob, int(rng.integers(0, 19)) * 8)),
        ("pack_group_name", (_text(rng, int(rng.integers(0, 17))),)),
        ("unpack_group_name", (_text(rng, 10).encode().ljust(20, b"\0"),)),
        ("pack_ext_name", (_text(rng, int(rng.integers(0, 7))),)),
        ("unpack_ext_name", (_text(rng, 4).encode().ljust(6, b"\0"),)),
        ("pack_prefix_name", (_text(rng, int(rng.integers(1, 17))),)),
        ("pack_metadata", (meta,)),
        ("unpack_metadata", (R.pack_metadata(meta),)),
        ("pack_scrub_stats", ({f: int(rng.integers(0, 1 << 40))
                               for f in R.SCRUB_STAT_FIELDS},)),
        ("unpack_scrub_stats", (blob[:8 * int(rng.integers(0, 20))],)),
        ("pack_ec_stats", ({f: int(rng.integers(0, 1 << 40))
                            for f in R.EC_STAT_FIELDS},)),
        ("unpack_ec_stats", (blob[:8 * int(rng.integers(0, 20))],)),
        ("pack_profile_ctl", (bool(rng.integers(0, 2)),
                              int(rng.integers(0, 1000)),
                              int(rng.integers(0, 100)))),
        ("pack_trace_ctx", (int(rng.integers(0, 1 << 63)) * 2 + 1,
                            int(rng.integers(0, 1 << 40)),
                            int(rng.integers(0, 4)))),
        ("unpack_trace_ctx", (bytes(rng.integers(0, 256, 16)
                                    .astype(np.uint8)),)),
        ("pack_priority", (int(rng.integers(0, 5)),)),
        ("unpack_priority", (bytes([int(rng.integers(0, 5))]),)),
        ("priority_frame", (int(rng.integers(0, 5)),)),
        ("pack_retry_after", (int(rng.integers(0, 100000)),)),
        ("unpack_retry_after", (blob[:int(rng.integers(0, 12))],)),
        ("admitted_at_level", (int(rng.integers(0, 5)),
                               int(rng.integers(-1, 5)))),
        ("default_priority_class", (int(rng.choice(
            [int(c) for c in R.StorageCmd] + [0, 255])),)),
    ]


FUNCTIONS = [name for name, _ in _cases(np.random.default_rng(0))]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_function_equals_reference(fn, seed):
    args = dict(_cases(np.random.default_rng(seed)))[fn]
    want = getattr(R, fn)(*args)
    got = getattr(T, fn)(*args)
    if fn == "unpack_header":
        want, got = (want.pkg_len, want.cmd, want.status), \
            (got.pkg_len, got.cmd, got.status)
    assert got == want


ROUND_TRIPS = [
    ("pack_header", "unpack_header", (12345, 11, 0)),
    ("long2buff", "buff2long", (-(2 ** 63),)),
    ("long2buff", "buff2long", (2 ** 63 - 1,)),
    ("pack_group_name", "unpack_group_name", ("group1",)),
    ("pack_ext_name", "unpack_ext_name", ("tar",)),
    ("pack_metadata", "unpack_metadata", ({"w": "1024", "h": "768"},)),
    ("pack_scrub_stats", "unpack_scrub_stats",
     ({"passes": 3, "chunks_corrupt": 1},)),
    ("pack_ec_stats", "unpack_ec_stats", ({"k": 4, "m": 2},)),
    ("pack_trace_ctx", "unpack_trace_ctx", (7, 9, 3)),
    ("pack_priority", "unpack_priority", (4,)),
    ("pack_retry_after", "unpack_retry_after", (250,)),
]


@pytest.mark.parametrize("pack,unpack,args", ROUND_TRIPS,
                         ids=[f"{p}-{i}" for i, (p, _, _) in
                              enumerate(ROUND_TRIPS)])
def test_round_trip_equals_reference(pack, unpack, args):
    got = getattr(T, unpack)(getattr(T, pack)(*args))
    want = getattr(R, unpack)(getattr(R, pack)(*args))
    if isinstance(want, R.Header):
        assert (got.pkg_len, got.cmd, got.status) == \
            (want.pkg_len, want.cmd, want.status)
        assert got.pack() == want.pack() == T.pack_header(*args)
    else:
        assert got == want


ERRORS = [
    ("unpack_header", (b"\0" * 9,)),
    ("unpack_header", (R.pack_header(-1, 1, 0),)),
    ("pack_group_name", ("x" * 17,)),
    ("pack_ext_name", ("toolong",)),
    ("pack_prefix_name", ("",)),
    ("pack_prefix_name", ("a/b",)),
    ("pack_prefix_name", ("a.b",)),
    ("pack_prefix_name", ("x" * 17,)),
    ("pack_metadata", ({"a\x01b": "1"},)),
    ("pack_metadata", ({"k": "a\x02c"},)),
    ("pack_metadata", ({"k\x02": "v"},)),
    ("pack_metadata", ({"k": "v\x01"},)),
    ("unpack_trace_ctx", (b"\0" * 15,)),
    ("pack_priority", (256,)),
    ("unpack_priority", (b"",)),
    ("buff2long", (b"\0" * 7,)),
]


@pytest.mark.parametrize("fn,args", ERRORS,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(ERRORS)])
def test_error_case_equals_reference(fn, args):
    with pytest.raises(Exception) as want:
        getattr(R, fn)(*args)
    with pytest.raises(Exception) as got:
        getattr(T, fn)(*args)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_sidecar_subset_kept_its_names():
    # The sidecar imports these from the port's protocol module.
    for name in ("HEADER_SIZE", "PROTO_PKG_LEN_SIZE", "Header", "pack_header",
                 "unpack_header"):
        assert hasattr(T, name)
    for op in ("DEDUP_FINGERPRINT", "DEDUP_QUERY", "DEDUP_COMMIT",
               "DEDUP_NEARDUPS", "DEDUP_FINGERPRINT_CUTS", "DEDUP_VERIFY",
               "RESP", "ACTIVE_TEST"):
        assert int(T.StorageCmd[op]) == int(R.StorageCmd[op])
