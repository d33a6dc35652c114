"""On the card only: a short run of each cell is correct, and the control
is not.  Run there with ``python -m pytest portbench/tests -m gpu``."""

import json
import subprocess
import sys

import pytest

from portbench import manifest


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def last_json(args):
    out = subprocess.run([sys.executable, "-m", *args], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    return out.returncode, json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_cell_is_correct_on_the_card(name):
    card()
    rc, res = last_json(["portbench.run", "--workload", name, "--seed",
                         "2147483659", "--seconds", "3", "--trace", "0"])
    assert rc == 0 and res["correct"], res
    assert res["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_control_is_wrong_on_the_card():
    card()
    rc, res = last_json(["portbench.control", "--workload",
                         "node_text_cdc.seg64", "--seed", "3",
                         "--seconds", "3"])
    assert rc == 0 and not res["correct"], res


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_cuts_on_the_card_are_the_program_cuts(name):
    card()
    from fastdfs_tpu_torch.ops import gear_cdc
    from portbench import cdc, corpus

    data = corpus.Corpus(manifest.cell(name).config["corpus"], 64 << 20, 1,
                         9).segment(0)
    assert cdc.chunk_cuts(data, 2048, 13, 65536, "cuda") == \
        gear_cdc.chunk_stream_np(data)
