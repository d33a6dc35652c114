"""The pool and its cuts: made from the seed alone, the same work for
every seed, and cut as the program's host chunker cuts."""

import hashlib

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


# SHA-256 of each segment's bytes and of its cuts (int64), at seed 7,
# 1 MiB segments, 4 segments, as the harness made them before each corpus
# kind and each call was a file of its own (commit 761f355): every seed's
# pool has to stay what it was, or the cells' numbers move.
POOL_SHA256 = {
    "text": [
        ("186dc37612a6ab65112c9af6fd2a0a1a"
         "b83f77fd28d8aa86543d73139aa47cd4",
         "e0adab39860080bb0e215a5d3a39c4a2"
         "2a5bd57b676897692018cbd9dc69f9ab"),
        ("562ad9f0c6ac70b97364443855599b16"
         "2726e114a7e678272f57d9c5aea5499e",
         "ba584eab1b6e2600a44f5fbbf46e6905"
         "bc6a6af56563c82dc8afadab37c14bb3"),
        ("4e44f8fab367ce72c59bc1b9c5e3edda"
         "6e5fe31f800e44b1078f217329c70c20",
         "c6938961effbc813f1b7d436b9e1db73"
         "5189418032f484ef776eb4f79f900bb1"),
        ("1d9837196ec88a4a0fbcdc8a331dc34f"
         "dbb3b2bf4de9f0e9bec95c189a542f54",
         "4e35fc0e25c9291bf9da54ad58cb8c14"
         "65a9f1ef0d91244ee243518b9f7e6903"),
    ],
    "binaries": [
        ("56ee7d1ec589c65377847ecc71d18267"
         "2fdb3822ab5bd02148bc69dac6cf268b",
         "31de8284fa3ebd8bd9e2d4235b456197"
         "cac1f1b3503434d17920639f5911acf7"),
        ("5fd7f5282e058bebd6b373abee5b7874"
         "4c482374c65b38e61b8534d059ae31b0",
         "6a7e9e2f7fb85966fb698f599df89a36"
         "34a38cca4108be5ee304f381fde5a9cf"),
        ("bd4daf1a5d39e534790298cfc908e860"
         "1dbb632195d96e8312f4fc1cd64c2266",
         "d376959a1722b4764bf920c595a50cf6"
         "0eef4e910acc5e765e4f02efb67876e8"),
        ("1dd9fef4382995aa4f5befb1b87bd132"
         "b0691b4647c701fe227282ec66b96e70",
         "c6bb699058a4a02b13ff3a2438b5e38c"
         "94884d1f1f62cd43f7a39a07295fc97b"),
    ],
}


@pytest.mark.parametrize("name,kind", [("node_text_cdc.seg64", "text"),
                                       ("group_bin_sha1.seg64", "binaries")])
def test_pool_is_the_same_hash_for_hash(name, kind):
    cell = manifest.cell(name)
    cell.traffic = dict(cell.traffic, segment_bytes=SEG)
    cell.config = dict(cell.config, corpus_bytes=4 * SEG)
    pool = run.make_pool(cell, 7, "cpu", lambda msg: None)
    assert [(hashlib.sha256(s.data).hexdigest(),
             hashlib.sha256(np.asarray(s.cuts, np.int64).tobytes())
             .hexdigest()) for s in pool] == POOL_SHA256[kind]
