"""Self-describing file-ID codec.

The port's copy of ``fastdfs_tpu/common/fileid.py``.

Reference: FastDFS file IDs (``group1/M00/02/44/<base64>.ext``) encode
everything needed to locate and validate a file with **no metadata
database**: group name, store-path index, two-level subdirectory, and a
base64 blob packing source-storage IP, create timestamp, file size (with
flag bits) and CRC32.  Reference anchors:
``storage/storage_service.c:storage_gen_filename()``,
``common/fdfs_global.c:fdfs_check_data_filename()``,
``client/storage_client.c:fdfs_get_file_info()``.

Blob layout (20 bytes, big-endian, mirrors the upstream field order):

    [0:4]   source storage IPv4 (packed)
    [4:8]   create timestamp (uint32 unix seconds)
    [8:16]  file-size field: flags | uniquifier | true size (see below)
    [16:20] CRC32 of the file content

File-size field (int64):
    bit 62          appender-file flag   (upstream: FDFS_APPENDER_FILE_SIZE)
    bit 61          trunk-file flag      (upstream: FDFS_TRUNK_FILE_MARK_SIZE)
    bit 60          slave-file flag
    bits 48..59     12-bit uniquifier (per-server upload counter slice; keeps
                    IDs unique when ip+ts+crc collide)
    bits 0..47      true file size (256 TiB max)

Base64 uses the URL-safe alphabet (``-``/``_``) without padding: 20 bytes →
exactly 27 chars (= upstream FDFS_FILENAME_BASE64_LENGTH).  The alphabet is
FastDFS-*shaped*, not guaranteed bit-compatible (reference mount was empty
at survey time — SURVEY.md provenance warning).
"""

from __future__ import annotations

import base64
import binascii
import posixpath
import re
import struct
from dataclasses import dataclass

from fastdfs_tpu_torch.common.protocol import FILENAME_BASE64_LENGTH

STORAGE_DATA_DIR_FORMAT = "%02X"
DEFAULT_SUBDIR_COUNT = 256

_SIZE_MASK = (1 << 48) - 1
_UNIQ_SHIFT = 48
_UNIQ_MASK = 0xFFF
FLAG_SLAVE = 1 << 60
FLAG_TRUNK = 1 << 61
FLAG_APPENDER = 1 << 62

_BLOB_STRUCT = struct.Struct(">IIqI")
# \Z (not $) so trailing newlines never sneak past; whitespace and control
# characters are excluded from group/ext classes — these strings arrive over
# the wire and end up in filesystem paths and logs.
# Prefix/ext character class mirrors the C++ codec (IsExt/IsSlavePrefix in
# fileid.cc): excludes '/', '.', whitespace AND all control bytes ≤ 0x20
# plus 0x7F, so both languages accept exactly the same IDs.
# Byte-class mirror of native/common/fileid.cc (IsSlavePrefix/ext check):
# reject '/', '.', control bytes, space, DEL — and nothing else.  A Unicode
# class like \s would also reject U+00A0/U+3000 etc., splitting the codec
# from the C++ side, which compares raw bytes only.
_SAFE = r"[^/.\x00-\x20\x7f]"
# Prefix cap is 2x the slave max: trunk IDs carry a 16-char slot-location
# segment first, optionally followed by a slave prefix (slave-of-trunk-
# master names).  Non-trunk IDs are re-checked against the 16 cap after
# the blob decode.
_FILE_ID_RE = re.compile(
    r"^(?P<group>[^\s/]{1,16})/M(?P<path>[0-9A-F]{2})/"
    r"(?P<sub1>[0-9A-F]{2})/(?P<sub2>[0-9A-F]{2})/"
    r"(?P<b64>[A-Za-z0-9_-]{27})(?P<prefix>" + _SAFE + r"{1,32})?"
    r"(?P<ext>\." + _SAFE + r"{1,6})?\Z"
)
_REMOTE_NAME_RE = re.compile(
    r"^M[0-9A-F]{2}/[0-9A-F]{2}/[0-9A-F]{2}/"
    r"[A-Za-z0-9_-]{27}(" + _SAFE + r"{1,32})?(\." + _SAFE + r"{1,6})?\Z"
)


@dataclass(frozen=True)
class TrunkLocation:
    """Slot location inside a trunk file (reference: FDFSTrunkFullInfo in
    storage/trunk_mgr/trunk_shared.h).  Carried in trunk file IDs as an
    extra 16-char base64 segment after the 27-char stem — the analogue of
    upstream's longer trunk logic filenames."""

    trunk_id: int    # trunk file number within the store path
    offset: int      # slot start (its 24-byte header) in the trunk file
    alloc_size: int  # whole slot size including the header


TRUNK_SUFFIX_LENGTH = 16  # base64(12 bytes)
_TRUNK_STRUCT = struct.Struct(">III")


def encode_trunk_suffix(loc: TrunkLocation) -> str:
    return _b64encode(_TRUNK_STRUCT.pack(loc.trunk_id, loc.offset,
                                         loc.alloc_size))


def decode_trunk_suffix(suffix: str) -> TrunkLocation:
    if len(suffix) != TRUNK_SUFFIX_LENGTH:
        raise ValueError(f"bad trunk suffix length: {len(suffix)}")
    raw = _b64decode(suffix)
    return TrunkLocation(*_TRUNK_STRUCT.unpack(raw))


@dataclass(frozen=True)
class FileInfo:
    """Decoded identity facts carried inside a file ID."""

    source_ip: str
    create_timestamp: int
    file_size: int
    crc32: int
    uniquifier: int = 0
    appender: bool = False
    trunk: bool = False
    slave: bool = False
    trunk_loc: TrunkLocation | None = None


@dataclass(frozen=True)
class FileId:
    """Parsed structural parts of a file ID string."""

    group: str
    store_path_index: int
    subdir1: int
    subdir2: int
    filename: str  # "<27 b64 chars>[.ext]"

    @property
    def remote_filename(self) -> str:
        """The part after the group name (what the storage protocol carries)."""
        return posixpath.join(
            f"M{self.store_path_index:02X}",
            STORAGE_DATA_DIR_FORMAT % self.subdir1,
            STORAGE_DATA_DIR_FORMAT % self.subdir2,
            self.filename,
        )

    def __str__(self) -> str:
        return f"{self.group}/{self.remote_filename}"


def pack_ip(ip: str) -> int:
    a, b, c, d = (int(x) for x in ip.split("."))
    for part in (a, b, c, d):
        if not 0 <= part <= 255:
            raise ValueError(f"bad IPv4 address {ip!r}")
    return (a << 24) | (b << 16) | (c << 8) | d


def unpack_ip(n: int) -> str:
    return f"{(n >> 24) & 0xFF}.{(n >> 16) & 0xFF}.{(n >> 8) & 0xFF}.{n & 0xFF}"


def _b64encode(blob: bytes) -> str:
    return base64.urlsafe_b64encode(blob).rstrip(b"=").decode("ascii")


def _b64decode(s: str) -> bytes:
    pad = (-len(s)) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


def subdirs_for_blob(blob: bytes, subdir_count: int = DEFAULT_SUBDIR_COUNT) -> tuple[int, int]:
    """Deterministic two-level subdirectory spread from the packed blob.

    Reference: upstream spreads files over ``subdir_count_per_path²``
    directories (``storage/storage_func.c:storage_make_data_dirs()``); the
    chosen pair is a pure function of the blob so any party holding the ID
    can compute the on-disk path.
    """
    h = binascii.crc32(blob)
    return ((h >> 16) & 0xFF) % subdir_count, (h & 0xFF) % subdir_count


def encode_file_id(
    group: str,
    store_path_index: int,
    source_ip: str,
    create_timestamp: int,
    file_size: int,
    crc32: int,
    ext: str = "",
    uniquifier: int = 0,
    appender: bool = False,
    trunk: bool = False,
    slave: bool = False,
    trunk_loc: TrunkLocation | None = None,
    subdir_count: int = DEFAULT_SUBDIR_COUNT,
) -> str:
    """Build a file-ID string (reference: storage_gen_filename())."""
    # Byte-length limits match the fixed-width wire fields
    # (protocol.pack_group_name / pack_ext_name) so every minted ID is
    # transmittable.
    if (not group or len(group.encode("utf-8")) > 16
            or any(c == "/" or c.isspace() or ord(c) < 0x20 for c in group)):
        raise ValueError(f"bad group name: {group!r}")
    ext = ext.lstrip(".")
    if ext and (len(ext.encode("utf-8")) > 6 or any(
            c in "/." or c.isspace() or ord(c) < 0x20 for c in ext)):
        raise ValueError(f"bad ext name: {ext!r}")
    if not 0 <= store_path_index <= 0xFF:
        raise ValueError(f"store_path_index out of range: {store_path_index}")
    if not 0 <= file_size <= _SIZE_MASK:
        raise ValueError(f"file_size out of range: {file_size}")
    if not 0 <= uniquifier <= _UNIQ_MASK:
        raise ValueError(f"uniquifier out of range: {uniquifier}")
    size_field = file_size | (uniquifier << _UNIQ_SHIFT)
    if appender:
        size_field |= FLAG_APPENDER
    if trunk:
        size_field |= FLAG_TRUNK
    if slave:
        size_field |= FLAG_SLAVE
    blob = _BLOB_STRUCT.pack(
        pack_ip(source_ip), create_timestamp & 0xFFFFFFFF, size_field, crc32 & 0xFFFFFFFF
    )
    if trunk != (trunk_loc is not None):
        raise ValueError("trunk flag requires trunk_loc (and vice versa)")
    sub1, sub2 = subdirs_for_blob(blob, subdir_count)
    name = _b64encode(blob)
    assert len(name) == FILENAME_BASE64_LENGTH
    if trunk_loc is not None:
        name += encode_trunk_suffix(trunk_loc)
    if ext:
        name += "." + ext
    return (
        f"{group}/M{store_path_index:02X}/"
        f"{STORAGE_DATA_DIR_FORMAT % sub1}/{STORAGE_DATA_DIR_FORMAT % sub2}/{name}"
    )


def decode_file_id(
    file_id: str, subdir_count: int = DEFAULT_SUBDIR_COUNT
) -> tuple[FileId, FileInfo]:
    """Parse and validate a file-ID string; inverse of :func:`encode_file_id`.

    Reference: ``fdfs_check_data_filename()`` + client-side
    ``fdfs_get_file_info()`` — download needs no index lookup because the ID
    itself names the group, path, and content facts.
    """
    m = _FILE_ID_RE.match(file_id)
    if m is None:
        raise ValueError(f"malformed file id: {file_id!r}")
    b64 = m.group("b64")
    blob = _b64decode(b64)
    ip_n, ts, size_field, crc = _BLOB_STRUCT.unpack(blob)
    prefix = m.group("prefix") or ""
    fid = FileId(
        group=m.group("group"),
        store_path_index=int(m.group("path"), 16),
        subdir1=int(m.group("sub1"), 16),
        subdir2=int(m.group("sub2"), 16),
        filename=b64 + prefix + (m.group("ext") or ""),
    )
    expect = subdirs_for_blob(blob, subdir_count)
    if expect != (fid.subdir1, fid.subdir2):
        raise ValueError(
            f"file id subdirs {fid.subdir1:02X}/{fid.subdir2:02X} do not match "
            f"blob hash {expect[0]:02X}/{expect[1]:02X}"
        )
    trunk = bool(size_field & FLAG_TRUNK)
    trunk_loc = None
    if trunk:
        # Trunk IDs: first 16 post-stem chars are the slot location
        # (disambiguated by the blob flag, as upstream does by the longer
        # trunk filename length); any remainder is a slave prefix — such a
        # slave is stored FLAT, so its trunk_loc stays None (the location
        # names the master's slot, not this file).
        if len(prefix) < TRUNK_SUFFIX_LENGTH:
            raise ValueError(f"trunk id missing location: {file_id!r}")
        try:
            loc = decode_trunk_suffix(prefix[:TRUNK_SUFFIX_LENGTH])
        except (ValueError, binascii.Error) as e:
            raise ValueError(f"bad trunk suffix in {file_id!r}") from e
        prefix = prefix[TRUNK_SUFFIX_LENGTH:]
        if not prefix:
            trunk_loc = loc
    elif len(prefix) > 16:
        raise ValueError(f"slave prefix too long: {file_id!r}")
    info = FileInfo(
        source_ip=unpack_ip(ip_n),
        create_timestamp=ts,
        file_size=size_field & _SIZE_MASK,
        crc32=crc,
        uniquifier=(size_field >> _UNIQ_SHIFT) & _UNIQ_MASK,
        appender=bool(size_field & FLAG_APPENDER),
        trunk=trunk,
        # A non-empty prefix after the base64 stem IS the slave marker
        # (reference: slave names are "<master stem><prefix>.<ext>").
        slave=bool(prefix) or (not trunk and bool(size_field & FLAG_SLAVE)),
        trunk_loc=trunk_loc,
    )
    return fid, info


def local_path(base_path: str, remote_filename: str) -> str:
    """Map a remote filename (``M00/XX/YY/name``) to the on-disk path
    ``<base_path>/data/XX/YY/name`` for the store path it names.

    Reference: storage daemons keep each store path's payload under
    ``<store_path>/data/`` (storage_func.c:storage_make_data_dirs()).
    """
    # Strict grammar — remote filenames arrive over the wire, so anything
    # loose here is a path traversal (``M00/../../etc`` must not escape).
    m = _REMOTE_NAME_RE.match(remote_filename)
    if m is None:
        raise ValueError(f"malformed remote filename: {remote_filename!r}")
    parts = remote_filename.split("/")
    return posixpath.join(base_path, "data", parts[1], parts[2], parts[3])
