"""mime.types parser.

The port's copy of ``fastdfs_tpu/common/mime.py``.

Reference: ``common/mime_file_parser.c`` — load_mime_types_from_file()
loads nginx-style ``conf/mime.types`` (``type ext1 ext2 ...;`` entries,
optionally wrapped in a ``types { ... }`` block) into an extension → type
map for the (legacy) HTTP serving path.
"""

from __future__ import annotations

DEFAULT_MIME_TYPE = "application/octet-stream"


def parse_mime_types(text: str) -> dict[str, str]:
    """ext (lowercase, no dot) -> mime type."""
    out: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip().rstrip(";").strip()
        if not line or line in ("types {", "types{", "{", "}"):
            continue
        parts = line.split()
        if len(parts) < 2 or "/" not in parts[0]:
            continue
        for ext in parts[1:]:
            out[ext.lower().lstrip(".")] = parts[0]
    return out


def load_mime_types(path: str) -> dict[str, str]:
    with open(path, encoding="utf-8") as fh:
        return parse_mime_types(fh.read())


def mime_type_for(filename: str, table: dict[str, str]) -> str:
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    return table.get(ext, DEFAULT_MIME_TYPE)
