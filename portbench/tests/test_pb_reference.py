"""The plain reference: SHA-1 against hashlib, the sketch against a
position-by-position reading of its specification."""

import hashlib

import numpy as np
import pytest

from portbench import reference as ref


def spans(data, cuts):
    return ref.spans_of(cuts)


def test_digests_are_hashlib_on_hand_made_spans():
    data = bytes(range(256)) * 40 + b"\x00" * 70
    cuts = [1, 2, 5, 60, 64, 127, 128, 200, 4000, 8000, len(data)]
    off, lens = ref.spans_of(cuts)
    words = ref.sha1_words(data, off, lens)
    for i, (o, n) in enumerate(zip(off, lens)):
        assert words[i].astype(">u4").tobytes() == \
            hashlib.sha1(data[o:o + n]).digest()


def slow_sketch(data, cuts, k=ref.SHINGLE, perms=ref.PERMS):
    """The specification read one position at a time."""
    a, b = ref.perm_constants(perms)
    out = []
    start = 0
    for end in cuts:
        chunk = data[start:end]
        n = len(chunk)
        z = {}
        positions = range(n - k + 1) if n >= k else range(max(n, 1))
        for p in positions:
            h = 0
            for j in range(k):
                byte = chunk[p + j] if p + j < n else 0
                h = (h * ref.POLY_B + byte) & 0xFFFFFFFF
            if h & ref.SAMPLE_MASK == 0:
                s = (p // 4) % ref.NUM_SEGMENTS
                z[s] = min(z.get(s, ref.EMPTY), h)
        sig = [min([(int(a[j]) * v + int(b[j])) & 0xFFFFFFFF
                    for v in z.values()], default=ref.EMPTY)
               for j in range(perms)]
        out.append(sig)
        start = end
    return np.array(out, dtype=np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_is_the_specification(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    cuts = [1, 3, 4, 5, 9, 600, 4700, 4703, 21000, 40000]
    ans = ref.answer(data, cuts)
    assert ans.survivors > 100
    assert np.array_equal(ans.sigs, slow_sketch(data, cuts))


def test_control_mask_changes_signatures():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    cuts = list(range(8192, len(data) + 1, 8192))
    good = ref.answer(data, cuts)
    coarse = ref.answer(data, cuts, sample_mask=0x1FF)
    assert np.array_equal(good.digests, coarse.digests)
    assert (good.sigs != coarse.sigs).any(axis=1).mean() > 0.9
