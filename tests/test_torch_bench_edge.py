"""The port's config 12 (``fastdfs_tpu_torch.bench_configs``), the
serving edge, on the CPU through ``tests/torch_native.py``'s daemons and
``fdfs_load``.

It runs once at its smallest corpus, 24 files of 256 KB: a 1-reactor and
a 4-reactor storage under the same open-loop download rates, a held
burst of sockets, the ranged downloader and a flamegraph of each arm,
taken by the port's CLI.  What is held to the reference: the artifact's
keys, at every level, are the checked-in reference artifact's (plus the
card line and ``fdfs_load``'s newer summary keys), and every file the
port's ranged downloader reads is read again, from the same daemons, by
the reference's own client (``fastdfs_tpu.client``), which must return
the same bytes.  The rest holds the port to its own correctness
verdicts and to ``main``'s dispatch; its latency ratios depend on the
host's load and are not held.  Also ``_run_load``'s pool-stats line on a
stubbed ``subprocess.run``.
"""

import json
import os
import subprocess
import sys

import pytest

from fastdfs_tpu.client.client import FdfsClient as ReferenceClient
from fastdfs_tpu_torch import bench_configs as bc
from torch_native import same_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALLEST = 1 / 65536   # 24 files of 256 KB, the reference's floor
# Keys of fdfs_load's summaries that the load driver writes today and
# the checked-in artifacts predate (tests/test_torch_bench_slab.py finds
# them in its source).
LOAD_ADDED = {"by_class", "shed"}
VERDICTS = ("zero_errors", "conn_budget_honored",
            "preadv_spans_exceed_batches", "accept_spread_within_2x")
ARMS = {"reactors1": 1, "reactors4": 4}


@pytest.fixture(scope="module")
def config12(tmp_path_factory):
    """``(artifact, out_dir, argvs, reads)``: config 12 on the CPU
    through ``main``, with the argv of every process it started
    (``subprocess.run`` starts each through ``subprocess.Popen``) and,
    for each file its ranged downloader read, ``(bytes read, whether the
    reference's client read the same bytes)``."""
    out = tmp_path_factory.mktemp("port12")
    argvs, reads = [], []

    class Recording(subprocess.Popen):
        def __init__(self, args, *a, **kw):
            argvs.append([str(x) for x in args])
            super().__init__(args, *a, **kw)

    class Checked(bc.FdfsClient):
        """The port's client; as the ranged downloader it reads each
        file again through the reference's single-stream client."""

        def __init__(self, trackers, *a, **kw):
            super().__init__(trackers, *a, **kw)
            self.reference = (ReferenceClient(trackers)
                              if self.parallel_downloads > 1 else None)

        def download_to_buffer(self, file_id, *a, **kw):
            got = super().download_to_buffer(file_id, *a, **kw)
            if self.reference is not None:
                want = self.reference.download_to_buffer(file_id)
                reads.append((len(got), got == want))
            return got

        def close(self):
            if self.reference is not None:
                self.reference.close()
            super().close()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "Popen", Recording)
        mp.setattr(bc, "FdfsClient", Checked)
        bc.main(["--config", "12", "--scale", str(SMALLEST), "--device",
                 "cpu", "--out", str(out)])
    with open(os.path.join(str(out), "config12.json")) as fh:
        return json.load(fh), str(out), argvs, reads


def test_config12_keys_are_the_references(config12):
    art, _, _, _ = config12
    with open(os.path.join(REPO, "bench_artifacts", "config12.json")) as fh:
        ref = json.load(fh)
    assert set(art) == set(ref) | {"card"}
    assert art["card"] is None
    same_keys({k: v for k, v in art.items() if k != "card"}, ref,
              LOAD_ADDED, "/preload")


@pytest.mark.parametrize("verdict", VERDICTS)
def test_config12_verdict_holds(config12, verdict):
    assert config12[0][verdict] is True


def test_config12_loses_no_byte(config12):
    art = config12[0]
    assert art["wrong_bytes"] == 0
    assert art["files"] == 24 and art["open_loop_ops"] == 96
    assert art["scaled_bytes"] == 24 * 256 * 1024
    assert len(art["offered_rates_qps"]) == 2


def test_config12_ranged_bytes_are_the_reference_clients(config12):
    reads = config12[3]
    assert len(reads) == 2 * 24
    assert reads == [(256 * 1024, True)] * len(reads)


@pytest.mark.parametrize("arm", ARMS)
def test_config12_arm(config12, arm):
    got = config12[0]["arms"][arm]
    reactors = ARMS[arm]
    assert got["reactors"] == reactors
    assert got["preload"]["errors"] == 0 and got["preload"]["ops"] == 24
    assert got["ranged_verify"] == {"files": 24, "wrong": 0,
                                    "ranged_fallbacks": 0}
    burst = got["accept_burst"]
    assert len(burst["conns_per_reactor"]) == reactors
    assert sum(burst["conns_per_reactor"].values()) >= 64
    assert got["preadv"]["spans"] > got["preadv"]["batches"] > 0
    for sweep in got["clients"].values():
        assert all(cell["errors"] == 0 and cell["pool"]["conns_opened"] >= 1
                   for cell in sweep)
    assert all(cell["pool"]["conns_peak"] == 1
               for cell in got["clients"]["single_conn"])
    if reactors > 1:
        assert got["reuseport_active"] == 1


@pytest.mark.parametrize("arm", ARMS)
def test_config12_flamegraph_is_written(config12, arm):
    art, out, _, _ = config12
    flame = art["arms"][arm]["flamegraph"]
    assert flame["folded_file"] == f"config12_{arm}.folded"
    assert (flame["hz"], flame["seconds"]) == (97, 3)
    assert flame["samples"] > 0
    with open(os.path.join(out, flame["folded_file"])) as fh:
        folded = fh.read().splitlines()
    assert len(folded) == flame["stacks"]
    assert sum(int(ln.rsplit(" ", 1)[1]) for ln in folded
               if " " in ln) == flame["samples"]


def test_config12_profiles_through_the_ports_cli(config12):
    art, _, argvs, _ = config12
    profiles = [i for i, a in enumerate(argvs) if "profile" in a]
    assert len(profiles) == 2
    rate = str(art["offered_rates_qps"][-1])
    for i in profiles:
        argv = argvs[i]
        assert argv[:6] == [sys.executable, "-m", "fastdfs_tpu_torch.cli",
                            "--device", "cpu", "profile"]
        assert argv[8:] == ["--hz", "97", "--seconds", "3"]
        # The flamegraph's load starts after the CLI, at the top rate.
        load = argvs[i + 1]
        assert load[1] == "download" and load[-3:] == ["--open-loop",
                                                       "--rate", rate]
    assert not [a for a in argvs
                if any(x.startswith("fastdfs_tpu.") for x in a)]


POOL_LINE = ('{"conns_budget": 1, "conns_opened": 1, "conns_peak": 1, '
             '"conn_waits": 0}')


@pytest.mark.parametrize("stdout,want", [
    (f"{POOL_LINE}\n", json.loads(POOL_LINE)),
    (f"progress 1/2\n{POOL_LINE}\ndone\n", json.loads(POOL_LINE)),
    ("", None),
    ('{"ops": 3}\n', None),
], ids=["line", "among-others", "empty", "other-json"])
def test_run_load_returns_the_pool_stats_line(stdout, want, monkeypatch):
    calls = []

    def fake_run(args, **kw):
        calls.append(args)
        return subprocess.CompletedProcess(args, 0, stdout.encode(), b"")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bc._run_load("fdfs_load", "download", "a", "b") == want
    assert calls == [["fdfs_load", "download", "a", "b"]]


def test_run_load_raises_with_stderr(monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda args, **kw:
                        subprocess.CompletedProcess(args, 2, b"", b"bad rate"))
    with pytest.raises(RuntimeError, match="bad rate"):
        bc._run_load("fdfs_load", "download")

