"""The port's entry points (fastdfs_tpu_torch.entry) and profile tool on
the CPU: ``entry(device="cpu")`` against the JAX package's pieces of
``__graft_entry__.entry`` on its own example arguments (hashlib for the
digests, whose XLA SHA-1 costs minutes of compile at this shape; the
reference's ``candidate_mask(gear_hashes(...))`` and ``minhash_batch``),
``dryrun_multichip`` on CPU ranks, and that without a card nothing runs
unless the caller places the ranks.

Tolerance: exact equality (integer digests, signatures and masks).
"""

import hashlib

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from fastdfs_tpu.ops.gear_cdc import candidate_mask as jcandidate_mask
from fastdfs_tpu.ops.gear_cdc import gear_hashes as jgear_hashes
from fastdfs_tpu.ops.minhash import minhash_batch as jminhash_batch
from fastdfs_tpu_torch import entry as tentry


@pytest.fixture(scope="module")
def cpu_entry():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    fn, args = tentry.entry(device="cpu")
    yield fn(*args), args
    torch.set_num_threads(prev)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def test_example_args_match_the_reference_entry():
    # Only the arguments: the reference's fn would compile its XLA SHA-1.
    _, (chunks, lengths) = tentry.entry(device="cpu")
    _, (want_c, want_l) = jentry.entry()
    assert np.array_equal(chunks, want_c) and np.array_equal(lengths, want_l)


def test_entry_digests_are_hashlib(cpu_entry):
    out, (chunks, _) = cpu_entry
    got = [d.astype(">u4").tobytes() for d in _u32(out["sha1"])]
    assert got == [hashlib.sha1(row.tobytes()).digest() for row in chunks]


def test_entry_signatures_match_reference(cpu_entry):
    out, (chunks, lengths) = cpu_entry
    assert np.array_equal(_u32(out["minhash"]),
                          np.asarray(jminhash_batch(chunks, lengths)))


def test_entry_cut_candidates_match_reference(cpu_entry):
    out, (chunks, _) = cpu_entry
    want = np.asarray(jcandidate_mask(jgear_hashes(chunks.reshape(-1))))
    assert np.array_equal(out["cut_candidates"].numpy(), want)
    assert out["n_candidates"].dtype == torch.int32
    assert int(out["n_candidates"]) == int(want.sum())


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_dryrun_multichip_on_cpu_ranks(n):
    tentry.dryrun_multichip(n, devices=["cpu"] * n)


def test_entry_and_dryrun_need_a_card_unless_ranks_are_placed():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(ValueError, match="asked for 2 devices, have 0"):
        tentry.dryrun_multichip(2)
    tentry.dryrun_multichip(2, devices=["cpu", "cpu"])


def test_profile_tool_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from fastdfs_tpu_torch.tools import profile_fingerprint

    assert profile_fingerprint.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
