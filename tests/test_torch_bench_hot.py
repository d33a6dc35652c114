"""The port's config 14 (``fastdfs_tpu_torch.bench_configs``), heat-driven
hot replication, on the CPU through ``tests/torch_native.py``'s daemons
and ``fdfs_load``.

It runs once at its smallest corpus, 12 files of 8 KB, on a tracker and
three groups of one storage each: the hot-map policy off, then on, each
arm warmed by ``fdfs_load --hot-keys 1:90`` and measured by eight
readers on the port's ``FdfsClient``.  What is held to the reference:
the artifact's keys, at every level, are the checked-in reference
artifact's (plus the card line), and every payload the port uploads is
the one root ``config14`` uploads, recorded from the reference's own
code (it stops after its first arm's corpus, before a daemon would be
needed).  The rest holds the port to its own correctness verdicts; the
spreads and hot-key p99s depend on the host's load and are not held.
"""

import json
import os
import tempfile
import types

import pytest

import bench_configs as ref_bc
import harness
from fastdfs_tpu.client import client as ref_client
from fastdfs_tpu_torch import bench_configs as bc
from torch_native import same_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALLEST = 1 / 65536   # 12 files of 8 KB, the reference's floor
FILE_BYTES = 8192
VERDICTS = ("hot_promotion_published", "routed_reads_flowed",
            "zero_read_errors")


@pytest.fixture(scope="module")
def config14(tmp_path_factory):
    """``(artifact, payloads)``: config 14 on the CPU through ``main``,
    with every payload it uploaded through ``_upload_retry``."""
    out = tmp_path_factory.mktemp("port14")
    payloads = []
    upload = bc._upload_retry

    def recording(cli, data, *a, **kw):
        payloads.append(data)
        return upload(cli, data, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bc, "_upload_retry", recording)
        bc.main(["--config", "14", "--scale", str(SMALLEST), "--device",
                 "cpu", "--out", str(out)])
    with open(os.path.join(str(out), "config14.json")) as fh:
        return json.load(fh), payloads


def test_config14_keys_are_the_references(config14):
    art, _ = config14
    with open(os.path.join(REPO, "bench_artifacts", "config14.json")) as fh:
        ref = json.load(fh)
    assert set(art) == set(ref) | {"card"}
    assert art["card"] is None
    same_keys({k: v for k, v in art.items() if k != "card"}, ref)


@pytest.mark.parametrize("verdict", VERDICTS)
def test_config14_verdict_holds(config14, verdict):
    assert config14[0][verdict] is True


class _Corpus(Exception):
    """Root ``config14`` has uploaded its first arm's corpus."""


class _Daemon:
    port = 1

    def stop(self):
        pass


class _Client:
    def __init__(self, *a, **kw):
        pass

    def cluster_stat(self):
        return {"groups": [{"name": g, "active": 1}
                           for g in ("group1", "group2", "group3")]}


@pytest.fixture(scope="module")
def reference_payloads(tmp_path_factory):
    """What root ``config14`` passes to ``_upload_retry`` on its first
    arm, the warm-up and then the corpus.  Its daemons and client are
    stand-ins, and its first ``fdfs_load`` run, the warm leg that follows
    the corpus, stops it."""
    payloads = []

    def upload(cli, data, *a, **kw):
        payloads.append(data)
        return f"group1/M00/00/00/{len(payloads)}"

    def run(*a, **kw):
        raise _Corpus

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp("ref14")))
        mp.setattr(harness, "start_tracker", lambda *a, **kw: _Daemon())
        mp.setattr(harness, "start_storage", lambda *a, **kw: _Daemon())
        mp.setattr(ref_client, "FdfsClient", _Client)
        mp.setattr(ref_bc, "_upload_retry", upload)
        mp.setattr(ref_bc, "subprocess", types.SimpleNamespace(run=run))
        with pytest.raises(_Corpus):
            ref_bc.config14("unused", SMALLEST)
    return payloads


def test_config14_uploads_the_references_warmup(config14, reference_payloads):
    """Each arm begins with the reference's warm-up upload."""
    warmup = reference_payloads[0]
    assert len(warmup) != FILE_BYTES
    assert [p for p in config14[1] if len(p) != FILE_BYTES] == [warmup] * 2


@pytest.mark.parametrize("i", range(12))
def test_config14_payloads_are_the_seeded_ones(config14, reference_payloads,
                                               i):
    corpus = [p for p in config14[1] if len(p) == FILE_BYTES]
    want = reference_payloads[1:]
    assert len(want) == 12 and len(want[i]) == FILE_BYTES
    # Each arm uploads the reference's corpus, in order.
    assert corpus[i] == corpus[12 + i] == want[i]


def test_config14_corpus(config14):
    art, payloads = config14
    corpus = [p for p in payloads if len(p) == FILE_BYTES]
    assert art["files"] == 12 and art["warm_ops"] == 1200
    assert art["scaled_bytes"] == 12 * FILE_BYTES
    assert len(corpus) == 24 and len(set(corpus)) == 12


@pytest.mark.parametrize("arm", ["off", "on"])
def test_config14_arm(config14, arm):
    got = config14[0]["arms"][arm]
    assert set(got["group_read_deltas"]) == {"group1", "group2", "group3"}
    for leg in ("classic_hot_keys_leg", "measured"):
        kc = got[leg]["by_key_class"]
        assert got[leg]["errors"] == 0
        assert kc["hot"]["ops"] > kc["cold"]["ops"] > 0
    if arm == "on":
        assert 1 <= len(got["published_extra_groups"]) <= 2
        assert got["hot_gauges"]["hot.promotions_total"] >= 1
        assert got["hot_route_reads"] > 0
    else:
        assert got["published_extra_groups"] == []
        assert got["hot_route_reads"] == 0
        assert got["hot_gauges"]["hot.promotions_total"] == 0
    assert got["offered_rate_qps"] == config14[0]["offered_rate_qps"]
