"""The port's last ``common/`` modules and package surface against the
reference: ``common/fileid.py``, ``common/mime.py``,
``common/http_token.py``, the protocol's beat-stat and wire-contract
tables, the re-exports of ``common`` and ``ops`` and ``__version__``.

The inputs are those of the reference's own suites
(``tests/test_fileid.py``, ``tests/test_http_token.py``) plus seeded
fuzz cases; each runs through both packages, and the results (values,
rendered IDs and paths, or the raised error's type and message) must be
equal.  Tolerance: exact equality.
"""

import dataclasses
import os
import random

import pytest

import fastdfs_tpu
import fastdfs_tpu.common as R_common
import fastdfs_tpu.ops as R_ops
import fastdfs_tpu_torch
import fastdfs_tpu_torch.common as T_common
import fastdfs_tpu_torch.ops as T_ops
from fastdfs_tpu.common import fileid as R_fid
from fastdfs_tpu.common import http_token as R_tok
from fastdfs_tpu.common import mime as R_mime
from fastdfs_tpu.common import protocol as R_proto
from fastdfs_tpu_torch.common import fileid as T_fid
from fastdfs_tpu_torch.common import http_token as T_tok
from fastdfs_tpu_torch.common import mime as T_mime
from fastdfs_tpu_torch.common import protocol as T_proto
from fastdfs_tpu_torch.ops import gear_cdc, minhash, sha1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def norm(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, str(x) if hasattr(x, "remote_filename")
                else None,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    return x


def outcome(fn):
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("raised", type(e).__name__, str(e))


def both(fn):
    """``fn(module)`` through the reference and the port."""
    return outcome(lambda: fn(R_fid)), outcome(lambda: fn(T_fid))


# ---------------------------------------------------------------------------
# fileid
# ---------------------------------------------------------------------------

def _trunk(F):
    return F.TrunkLocation(trunk_id=9, offset=1 << 20, alloc_size=4096)


# (args, kwargs) of encode_file_id, from tests/test_fileid.py.  A value
# "TRUNK" is replaced by each side's own TrunkLocation.
ENCODE = [
    (("group1", 0, "192.168.1.102", 1_406_000_000, 30790, 0xFCEFEF3C),
     {"ext": "jpg"}),
    (("g", 3, "10.0.0.1", 0, 0, 0), {}),
    (("group2", 255, "10.1.2.3", 1_700_000_000, (1 << 48) - 1, 0),
     {"ext": "bin", "uniquifier": 0xABC, "appender": True}),
    (("g", 0, "1.2.3.4", 5, 6, 7), {"trunk": True, "trunk_loc": "TRUNK"}),
    (("group1", 0, "1.2.3.4", 1, 2, 3), {"ext": "txt"}),
    (("group1", 0, "1.2.3.4", 1, 2, 3), {"ext": "tar.gz"}),
    (("group1", 0, "1.2.3.4", 1, 2, 3), {"ext": "toolong7"}),
    (("g/1", 0, "1.2.3.4", 1, 2, 3), {}),
    (("x" * 17, 0, "1.2.3.4", 1, 2, 3), {}),
    (("g", 0, "1.2.3.4", 1, 2, 3), {"uniquifier": 0x1000}),
    (("g", 256, "1.2.3.4", 1, 2, 3), {}),
    (("g", 0, "1.2.3.4", 1, 2, 3), {"subdir_count": 16}),
    (("g", 0, "1.2.3.4", 1, 2, 3), {"ext": "ééé"}),
    (("g", 0, "1.2.3.4", 1, 2, 3), {"ext": "éééé"}),
    (("ééééééééé", 0, "1.2.3.4", 1, 2, 3), {}),
    (("group1", 0, "10.0.0.9", 1700000000, 123, 0xABCD),
     {"ext": "jpg", "slave": True}),
    (("g", 0, "256.1.1.1", 1, 2, 3), {}),
]
_rng = random.Random(1234)
for _ in range(24):
    ENCODE.append((("group9", _rng.randrange(256),
                    ".".join(str(_rng.randrange(256)) for _ in range(4)),
                    _rng.randrange(2 ** 32), _rng.randrange(2 ** 48),
                    _rng.randrange(2 ** 32)),
                   {"ext": "dat", "uniquifier": _rng.randrange(2 ** 12)}))


def _encode(F, args, kw):
    kw = {k: _trunk(F) if v == "TRUNK" else v for k, v in kw.items()}
    return F.encode_file_id(*args, **kw)


@pytest.mark.parametrize("idx", range(len(ENCODE)))
def test_file_id_round_trip_equals_reference(idx):
    args, kw = ENCODE[idx]
    ref, got = both(lambda F: _encode(F, args, kw))
    assert got == ref
    if ref[0] == "ok":
        sub = {"subdir_count": kw["subdir_count"]} if "subdir_count" in kw \
            else {}
        ref, got = both(lambda F: F.decode_file_id(ref[1], **sub))
        assert ref[0] == "ok"
        assert got == ref


def _good():
    return R_fid.encode_file_id("group1", 0, "1.2.3.4", 1, 2, 3, ext="txt")


def _tampered():
    parts = R_fid.encode_file_id("group1", 0, "1.2.3.4", 1, 2, 3).split("/")
    parts[2] = "%02X" % ((int(parts[2], 16) + 1) % 256)
    return "/".join(parts)


def _slave_nbsp():
    base = R_fid.encode_file_id("group1", 0, "10.0.0.9", 1700000000, 123,
                                0xABCD, ext="jpg", slave=True)
    stem, ext = base.rsplit(".", 1)
    return stem + "\u00a0x." + ext


DECODE = ["", "group1/M00/00/00", _good().replace("/M", "/X"),
          _good() + "/extra", "toolonggroupname01/M00/00/00/" + "A" * 27,
          _tampered(), _slave_nbsp(), _good().replace("group1", "grp_2"),
          _good()[:-5] + "!" + _good()[-4:], _good().upper()]


@pytest.mark.parametrize("idx", range(len(DECODE)))
def test_decode_file_id_equals_reference(idx):
    ref, got = both(lambda F: F.decode_file_id(DECODE[idx]))
    assert got == ref


LOCAL = ["M00/../../passwd", "M00/00/../xxxxxxxxxxxxxxxxxxxxxxxxxxx",
         "M00/00/00/../../../../etc/passwd", "M00/0G/00/" + "A" * 27,
         "M00/00/00/..", "M00/00/00/" + "A" * 27 + "\n",
         "M00/00/00/" + "A" * 27 + ".e\nx", "no/such/shape",
         _good().split("/", 1)[1], _slave_nbsp().split("/", 1)[1]]


@pytest.mark.parametrize("idx", range(len(LOCAL)))
def test_local_path_equals_reference(idx):
    ref, got = both(lambda F: F.local_path("/var/fdfs/path0", LOCAL[idx]))
    assert got == ref


@pytest.mark.parametrize("ip", ["0.0.0.0", "255.255.255.255", "192.168.1.1",
                                "256.1.1.1", "1.2.3", "a.b.c.d"])
def test_ip_pack_equals_reference(ip):
    ref, got = both(lambda F: F.unpack_ip(F.pack_ip(ip)))
    assert got == ref


@pytest.mark.parametrize("loc", [(0, 0, 0), (9, 1 << 20, 4096),
                                 (2 ** 32 - 1, 2 ** 31, 7)])
def test_trunk_suffix_and_subdirs_equal_reference(loc):
    ref, got = both(lambda F: F.encode_trunk_suffix(F.TrunkLocation(*loc)))
    assert got == ref
    ref, got = both(lambda F: F.decode_trunk_suffix(ref[1]))
    assert got == ref
    blob = bytes(random.Random(loc[0]).randrange(256) for _ in range(20))
    for count in (1, 16, 256):
        ref, got = both(lambda F: F.subdirs_for_blob(blob, count))
        assert got == ref


def test_fileid_constants_equal_reference():
    for name in ("STORAGE_DATA_DIR_FORMAT", "DEFAULT_SUBDIR_COUNT",
                 "FLAG_SLAVE", "FLAG_TRUNK", "FLAG_APPENDER",
                 "TRUNK_SUFFIX_LENGTH"):
        assert getattr(T_fid, name) == getattr(R_fid, name), name
    assert T_fid.FILENAME_BASE64_LENGTH is T_proto.FILENAME_BASE64_LENGTH


# ---------------------------------------------------------------------------
# http_token and mime
# ---------------------------------------------------------------------------

TOKENS = [("/group1/M00/00/00/abc.jpg", "s3cret", 1700000000),
          ("/g/x", "", 0), ("/ünïcode/påth", "密钥", 9876543210),
          ("/g/M00/AA/BB/x.png", "k3y", 1234567890)]


@pytest.mark.parametrize("uri,secret,ts", TOKENS)
def test_http_token_equals_reference(uri, secret, ts):
    tok = R_tok.http_gen_token(uri, secret, ts)
    assert T_tok.http_gen_token(uri, secret, ts) == tok
    for args in ((tok, uri, secret, ts, ts + 100, 600),
                 (tok, uri, secret, ts, ts + 1000, 600),
                 (tok, uri, "other", ts, ts + 100, 600),
                 (tok, uri + "x", secret, ts, ts + 100, 600),
                 (tok, uri, secret, ts + 1, ts + 100, 600),
                 (tok, uri, secret, ts, ts + 10 ** 9, 0),
                 (tok.upper(), uri, secret, ts, ts, 600)):
        assert T_tok.http_check_token(*args) == R_tok.http_check_token(*args)


MIME_SAMPLE = """\
# nginx-style
types {
    text/html                             html htm shtml;
    image/jpeg                            jpeg jpg;
    application/octet-stream              bin exe dll;
}
"""

MIME_TEXTS = [MIME_SAMPLE, "", "types{\n}\n", "bogus\nnoslash ext;\n"
              "text/plain txt .TXT  # comment\n"]


@pytest.mark.parametrize("idx", range(len(MIME_TEXTS)))
def test_mime_parser_equals_reference(idx):
    ref = R_mime.parse_mime_types(MIME_TEXTS[idx])
    assert T_mime.parse_mime_types(MIME_TEXTS[idx]) == ref
    for name in ("photo.JPG", "noext", "weird.xyz", "a.b.txt", ".bin"):
        assert (T_mime.mime_type_for(name, ref)
                == R_mime.mime_type_for(name, ref))


def test_mime_types_file_equals_reference():
    path = os.path.join(REPO, "conf", "mime.types")
    table = T_mime.load_mime_types(path)
    assert table == R_mime.load_mime_types(path)
    assert table
    assert T_mime.DEFAULT_MIME_TYPE == R_mime.DEFAULT_MIME_TYPE


# ---------------------------------------------------------------------------
# protocol tables and the package surface
# ---------------------------------------------------------------------------

def test_beat_stat_table_equals_reference():
    assert T_proto.BEAT_STAT_FIELDS == R_proto.BEAT_STAT_FIELDS
    assert T_proto.BEAT_STAT_COUNT == len(T_proto.BEAT_STAT_FIELDS)


def test_wire_annotations_name_port_opcodes():
    assert T_proto.NO_WIRE_BODY == R_proto.NO_WIRE_BODY
    assert T_proto.WIRE_GOLDENS == R_proto.WIRE_GOLDENS
    for name in T_proto.NO_WIRE_BODY | set(T_proto.WIRE_GOLDENS):
        enum_name, member = name.split(".")
        assert member in getattr(T_proto, enum_name).__members__, name


def test_common_reexports_equal_reference():
    names = {n for n in vars(R_common) if not n.startswith("_")
             and not isinstance(getattr(R_common, n), type(os))}
    assert names <= set(vars(T_common))
    assert T_common.decode_file_id is T_fid.decode_file_id
    assert T_common.Header is T_proto.Header
    fid = R_common.encode_file_id("group1", 0, "1.2.3.4", 1, 2, 3)
    assert T_common.encode_file_id("group1", 0, "1.2.3.4", 1, 2, 3) == fid


def test_ops_reexports_equal_reference():
    names = {n for n in vars(R_ops) if not n.startswith("_")
             and not isinstance(getattr(R_ops, n), type(os))}
    assert names <= set(vars(T_ops))
    for n in names:
        src = {gear_cdc, sha1, minhash}
        assert any(getattr(m, n, None) is getattr(T_ops, n) for m in src), n
    assert (T_ops.GEAR_TABLE == R_ops.GEAR_TABLE).all()
    data = bytes(random.Random(3).randrange(256) for _ in range(50_000))
    assert T_ops.chunk_stream_ref(data, 64, 8, 1024) == \
        R_ops.chunk_stream_ref(data, 64, 8, 1024)


def test_version_equals_reference():
    assert fastdfs_tpu_torch.__version__ == fastdfs_tpu.__version__
    assert fastdfs_tpu_torch.FDFS_TPU_VERSION == fastdfs_tpu.FDFS_TPU_VERSION
