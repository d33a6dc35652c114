"""The pool and its cuts: made from the seed alone, the same work for
every seed, and cut as the program's host chunker cuts."""

import numpy as np
import pytest

from fastdfs_tpu_torch.ops import gear_cdc
from portbench import cdc, corpus, manifest, run

SEG = 1 << 20


def spec(name):
    return manifest.cell(name).config["corpus"]


@pytest.mark.parametrize("name", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_same_seed_same_pool_and_cuts(name):
    cell = manifest.cell(name)
    cell.traffic = dict(cell.traffic, segment_bytes=SEG)
    cell.config = dict(cell.config, corpus_bytes=3 * SEG)
    big = 2 ** 31 + 12345

    def pool(seed):
        return [(s.data, s.cuts) for s in run.make_pool(
            cell, seed, "cpu", lambda msg: None)]

    a = pool(big)
    assert a == pool(big)
    assert all(len(data) == SEG for data, _ in a)
    assert len({data for data, _ in a}) == 3          # distinct segments
    assert pool(big + 1)[0][0] != a[0][0]


def test_every_seed_gets_the_same_binary_make_up():
    c = spec("group_bin_sha1.seg64")
    zero = np.zeros(c["zero_bytes"], dtype=np.uint8).tobytes()

    def zero_runs(seed):
        data = corpus.Corpus(c, SEG, 2, seed).segment(0)
        step = c["zero_bytes"]
        return sum(data[i:i + step] == zero for i in range(0, SEG, step))

    plan = corpus.Corpus(c, SEG, 2, 1).plans[0]
    assert plan == corpus.Corpus(c, SEG, 2, 99).plans[0]
    # Parts of 128 and 256 KiB fall on 128 KiB steps, so every planned
    # zero run is found (but one that the seed's order puts past the
    # segment's end), and fresh random blocks are never zero.
    for seed in (1, 2 ** 33 + 7):
        assert plan.count(1) - 1 <= zero_runs(seed) <= plan.count(1)


def test_text_is_sentences_of_the_vocabulary():
    c = spec("node_text_cdc.seg64")
    data = corpus.Corpus(c, SEG, 1, 5).segment(0)
    words = data.replace(b".", b" ").split()
    # Parts join where they were cut, mid-word at times, as the
    # reference's documents do.
    vocab = {f"w{j}".encode() for j in range(c["vocabulary"])}
    assert sum(w in vocab for w in words) > 0.99 * len(words)
    assert data.count(b". ") > SEG // (18 * 7)


@pytest.mark.parametrize("name", ["node_text_cdc.seg64",
                                  "group_bin_sha1.seg64"])
def test_frozen_cuts_are_the_program_cuts(name):
    data = corpus.Corpus(spec(name), SEG, 2, 7).segment(1)
    assert cdc.chunk_cuts(data, 2048, 13, 65536, "cpu") == \
        gear_cdc.chunk_stream_np(data)


@pytest.mark.parametrize("n", [1, 31, 4096, 4097, (1 << 23) + 77])
def test_frozen_cuts_on_edges(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert cdc.chunk_cuts(data, 2048, 13, 65536, "cpu") == \
        gear_cdc.chunk_stream_np(data)
