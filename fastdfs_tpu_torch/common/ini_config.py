"""FastDFS-style INI config reader; the port's copy of
``fastdfs_tpu/common/ini_config.py``.

Reference: libfastcommon ``ini_file_reader.c`` — a flat ``key = value``
format (no mandatory sections) with ``#`` comments, repeated keys (e.g.
multiple ``tracker_server`` lines), and an ``#include other.conf``
directive resolved relative to the including file.  The daemons' conf files
(``conf/tracker.conf``, ``conf/storage.conf``, ``conf/client.conf``) are
the de-facto documentation of every tunable, so keeping the syntax
compatible lets users carry their configs over.
"""

from __future__ import annotations

import os
import re
from typing import Iterable

_SIZE_SUFFIX = {"": 1, "B": 1, "K": 1 << 10, "KB": 1 << 10, "M": 1 << 20,
                "MB": 1 << 20, "G": 1 << 30, "GB": 1 << 30, "T": 1 << 40,
                "TB": 1 << 40}
_TIME_SUFFIX = {"": 1, "s": 1, "m": 60, "h": 3600, "d": 86400}
_TRUE = {"1", "yes", "true", "on"}
_FALSE = {"0", "no", "false", "off"}


class IniConfig:
    """Parsed config: every key maps to a list of values in file order."""

    def __init__(self) -> None:
        self._items: dict[str, list[str]] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "IniConfig":
        cfg = cls()
        cfg._load_file(path, seen=set())
        return cfg

    @classmethod
    def loads(cls, text: str, base_dir: str | None = None) -> "IniConfig":
        """Parse from a string.  ``#include`` directives are rejected unless
        ``base_dir`` says where to resolve them (a bare string has no
        containing file to be relative to)."""
        cfg = cls()
        cfg._parse_lines(text.splitlines(), base_dir=base_dir, seen=set())
        return cfg

    def _load_file(self, path: str, seen: set[str]) -> None:
        # `seen` is the *active include stack*, not all files ever loaded:
        # entries are removed on return so diamond includes are legal and
        # only true cycles are rejected.
        real = os.path.realpath(path)
        if real in seen:
            raise ValueError(f"#include cycle at {path}")
        seen.add(real)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                self._parse_lines(fh, base_dir=os.path.dirname(real), seen=seen)
        finally:
            seen.discard(real)

    def _parse_lines(self, lines: Iterable[str], base_dir: str | None,
                     seen: set[str]) -> None:
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith(("#", ";")):
                m = re.match(r"#include\s+(\S.*)$", line)
                if m:
                    if base_dir is None:
                        raise ValueError(
                            "#include in a string config: pass base_dir to loads()")
                    self._load_file(os.path.join(base_dir, m.group(1).strip()), seen)
                continue
            if re.fullmatch(r"\[[^\]]*\]", line):
                continue  # section headers tolerated, flattened (upstream-compatible)
            key, sep, value = line.partition("=")
            if not sep:
                continue
            key = key.strip()
            value = value.strip()
            self._items.setdefault(key, []).append(value)

    # -- accessors ---------------------------------------------------------

    def get(self, key: str, default: str | None = None) -> str | None:
        vals = self._items.get(key)
        return vals[-1] if vals else default

    def get_all(self, key: str) -> list[str]:
        return list(self._items.get(key, []))

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None or v == "" else int(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None or v == "":
            return default
        lv = v.lower()
        if lv in _TRUE:
            return True
        if lv in _FALSE:
            return False
        raise ValueError(f"bad boolean for {key}: {v!r}")

    def get_bytes(self, key: str, default: int = 0) -> int:
        """Parse sizes like ``256KB``, ``64MB``, ``4G`` (reference:
        ini_file_reader's iniGetByteValue used for buff_size etc.)."""
        v = self.get(key)
        if v is None or v == "":
            return default
        m = re.fullmatch(r"(\d+)\s*([A-Za-z]*)", v)
        if not m or m.group(2).upper() not in _SIZE_SUFFIX:
            raise ValueError(f"bad size for {key}: {v!r}")
        return int(m.group(1)) * _SIZE_SUFFIX[m.group(2).upper()]

    def get_seconds(self, key: str, default: int = 0) -> int:
        """Parse durations like ``30``, ``5m``, ``1h``, ``1d``."""
        v = self.get(key)
        if v is None or v == "":
            return default
        m = re.fullmatch(r"(\d+)\s*([smhdSMHD]?)", v)
        if not m:
            raise ValueError(f"bad duration for {key}: {v!r}")
        return int(m.group(1)) * _TIME_SUFFIX[m.group(2).lower()]

    def keys(self) -> list[str]:
        return list(self._items.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._items
