"""The port's ``common/ini_config.py`` and ``common/jumphash.py`` against
the reference's, on the reference's own test texts and on seeded keys.
Tolerance: exact equality (parsed values, buckets, keys, error types)."""

import os

import numpy as np
import pytest

from fastdfs_tpu.common import ini_config as R_ini
from fastdfs_tpu.common import jumphash as R_jh
from fastdfs_tpu_torch.common import ini_config as T_ini
from fastdfs_tpu_torch.common import jumphash as T_jh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The texts of tests/test_ini_config.py, and each accessor call made on it.
TEXTS = {
    "basic": ("""
        # tracker settings
        disabled = false
        port = 22122
        bind_addr =
        store_lookup = 2
        """, [("get_int", "port"), ("get_bool", "disabled"),
              ("get", "bind_addr"), ("get_int", "store_lookup"),
              ("contains", "port"), ("contains", "nope")]),
    "repeated": ("""
        tracker_server = 10.0.0.1:22122
        tracker_server = 10.0.0.2:22122
        store_path0 = /data/fdfs0
        store_path1 = /data/fdfs1
        """, [("get_all", "tracker_server"), ("get", "tracker_server"),
              ("get", "store_path1")]),
    "sizes": ("""
        buff_size = 256KB
        trunk_file_size = 64MB
        heart_beat_interval = 30
        sync_wait_msec = 5m
        rotate = 1d
        """, [("get_bytes", "buff_size"), ("get_bytes", "trunk_file_size"),
              ("get_seconds", "heart_beat_interval"),
              ("get_seconds", "sync_wait_msec"), ("get_seconds", "rotate"),
              ("get_bytes", "missing"), ("get_seconds", "missing")]),
    "bad": ("x = notabool\ny = 12QQ\n",
            [("get_bool", "x"), ("get_bytes", "y"), ("get_int", "x")]),
    "comment": ("#includes are resolved relative to this file\nx = 1\n",
                [("get_int", "x")]),
    "upper": ("interval = 5M\n", [("get_seconds", "interval")]),
    "sections": ("[global]\nport = 1\n[other]\nname = x\n",
                 [("get_int", "port"), ("get", "name"), ("keys", None)]),
    "noequals": ("just words\n; semicolon comment\nk=v\n",
                 [("keys", None), ("get", "k")]),
}


def _call(cfg, method, key):
    try:
        if method == "contains":
            return key in cfg
        if method == "keys":
            return cfg.keys()
        return getattr(cfg, method)(key)
    except Exception as e:  # noqa: BLE001 — the error type is compared
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_ini_text_equals_reference(name):
    text, calls = TEXTS[name]
    ref = R_ini.IniConfig.loads(text)
    port = T_ini.IniConfig.loads(text)
    for method, key in calls:
        assert _call(port, method, key) == _call(ref, method, key), method


def _write_includes(tmp_path):
    (tmp_path / "base.conf").write_text("port = 22122\nshared = base\n")
    (tmp_path / "main.conf").write_text(
        "#include base.conf\nshared = main\nextra = 1\n")
    (tmp_path / "shared.conf").write_text("common = 1\n")
    (tmp_path / "a.conf").write_text("#include shared.conf\na = 1\n")
    (tmp_path / "b.conf").write_text("#include shared.conf\nb = 1\n")
    (tmp_path / "diamond.conf").write_text(
        "#include a.conf\n#include b.conf\n")
    (tmp_path / "c1.conf").write_text("#include c2.conf\n")
    (tmp_path / "c2.conf").write_text("#include c1.conf\n")


@pytest.mark.parametrize("conf", ["main.conf", "diamond.conf", "c1.conf"])
def test_ini_include_equals_reference(tmp_path, conf):
    _write_includes(tmp_path)
    path = str(tmp_path / conf)
    out = []
    for mod in (R_ini, T_ini):
        try:
            cfg = mod.IniConfig.load(path)
            out.append([(k, cfg.get_all(k)) for k in cfg.keys()])
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


def test_ini_loads_include_needs_base_dir(tmp_path):
    for mod in (R_ini, T_ini):
        with pytest.raises(ValueError):
            mod.IniConfig.loads("#include extra.conf\n")
    (tmp_path / "extra.conf").write_text("x = 7\n")
    got = T_ini.IniConfig.loads("#include extra.conf\n",
                                base_dir=str(tmp_path))
    assert got.get_int("x") == 7


@pytest.mark.parametrize("conf", ["client.conf", "storage.conf",
                                  "tracker.conf"])
def test_ini_shipped_confs_equal_reference(conf):
    path = os.path.join(REPO, "conf", conf)
    ref = R_ini.IniConfig.load(path)
    port = T_ini.IniConfig.load(path)
    assert port.keys() == ref.keys()
    assert all(port.get_all(k) == ref.get_all(k) for k in ref.keys())


@pytest.mark.parametrize("seed", range(6))
def test_jump_hash_equals_reference(seed):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 1 << 63, 200, dtype=np.int64)]
    keys += [0, 1, (1 << 64) - 1, -1]
    for buckets in (1, 2, 3, 7, 10, 64, 1000):
        assert ([T_jh.jump_hash(k, buckets) for k in keys]
                == [R_jh.jump_hash(k, buckets) for k in keys])


@pytest.mark.parametrize("seed", range(4))
def test_placement_and_range_keys_equal_reference(seed):
    rng = np.random.default_rng(100 + seed)
    names = ["".join(chr(c) for c in rng.integers(97, 123, int(n)))
             for n in rng.integers(1, 40, 50)]
    for name in names:
        assert T_jh.placement_key(name) == R_jh.placement_key(name)
        fid = f"group1/M00/00/00/{name}.bin"
        for n in (1, 2, 3, 5):
            assert T_jh.group_for_key(name, n) == R_jh.group_for_key(name, n)
            for i in range(4):
                assert (T_jh.replica_for_range(fid, i, n)
                        == R_jh.replica_for_range(fid, i, n))
                assert T_jh.range_key(fid, i) == R_jh.range_key(fid, i)


@pytest.mark.parametrize("buckets", [0, -3])
def test_jump_hash_rejects_empty_bucket_set(buckets):
    for mod in (R_jh, T_jh):
        with pytest.raises(ValueError, match="num_buckets must be positive"):
            mod.jump_hash(5, buckets)
