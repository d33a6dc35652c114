"""The port's bounded-window streaming (fastdfs_tpu_torch.ops.streaming)
against the JAX package's ``stream_batches``.

Both run the same cheap step (a weighted row sum plus the length), in
``jax.jit`` and in PyTorch, over the same seeded batches; the results must
come back in submission order and equal.  The reference's XLA SHA-1 is
left out: it compiles for minutes per shape.  Tolerance: exact equality
(integer results).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdfs_tpu.ops.streaming import stream_batches as j_stream
from fastdfs_tpu_torch.ops.streaming import stream_batches


def _batches(n=7, rows=3, width=64, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (rows, width), dtype=np.uint8),
             rng.randint(1, width + 1, rows).astype(np.int32))
            for _ in range(n)]


_W = np.arange(1, 65, dtype=np.int32)


def _t_step(batch, lens):
    return (batch.to(torch.int32) * torch.from_numpy(_W)).sum(1) + lens


_j_step = jax.jit(lambda b, ln: (b.astype(jnp.int32) * _W).sum(1) + ln)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_order_and_values_match_reference(depth):
    batches = _batches()
    got = list(stream_batches(iter(batches), _t_step, depth=depth,
                              device="cpu"))
    want = list(j_stream(iter(batches), _j_step, depth=depth))
    assert len(got) == len(want) == len(batches)
    for (batch, lens), g, w in zip(batches, got, want):
        assert isinstance(g, np.ndarray)
        assert np.array_equal(g, np.asarray(w))
        direct = (batch.astype(np.int64) * _W).sum(1) + lens
        assert np.array_equal(g, direct)


def test_depth_below_one_raises():
    with pytest.raises(ValueError):
        list(stream_batches(iter(_batches(2)), _t_step, depth=0,
                            device="cpu"))
    with pytest.raises(ValueError):
        list(j_stream(iter(_batches(2)), _j_step, depth=0))


def test_empty_stream_yields_nothing():
    assert list(stream_batches(iter([]), _t_step, device="cpu")) == []


def test_tuple_result_comes_back_as_numpy():
    def step(batch, lens):
        return batch.amax(1), lens * 2

    got = list(stream_batches(iter(_batches(4)), step, depth=2,
                              device="cpu"))
    for (batch, lens), res in zip(_batches(4), got):
        assert isinstance(res, tuple) and len(res) == 2
        assert all(isinstance(x, np.ndarray) for x in res)
        assert np.array_equal(res[0], batch.max(1))
        assert np.array_equal(res[1], lens * 2)


def test_dict_result_comes_back_as_numpy():
    def step(batch, lens):
        return {"first": batch[:, 0], "lens": lens,
                "nested": [lens + 1, batch.shape[0]]}

    got = list(stream_batches(iter(_batches(3)), step, depth=1,
                              device="cpu"))
    jgot = list(j_stream(iter(_batches(3)), jax.jit(
        lambda b, ln: {"first": b[:, 0], "lens": ln}), depth=1))
    for (batch, lens), res, jres in zip(_batches(3), got, jgot):
        assert set(res) == {"first", "lens", "nested"}
        assert isinstance(res["first"], np.ndarray)
        assert np.array_equal(res["first"], np.asarray(jres["first"]))
        assert np.array_equal(res["lens"], np.asarray(jres["lens"]))
        assert isinstance(res["nested"], list)
        assert np.array_equal(res["nested"][0], lens + 1)
        assert res["nested"][1] == 3


def test_window_holds_at_most_depth_plus_one_batches():
    # The reference's window: a result is fetched once depth + 1 batches
    # have been submitted.
    submitted = []

    def source():
        for i, b in enumerate(_batches(6)):
            submitted.append(i)
            yield b

    stream = stream_batches(source(), _t_step, depth=2, device="cpu")
    next(stream)
    assert submitted == [0, 1, 2]
    assert len(list(stream)) == 5


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        list(stream_batches(iter(_batches(1)), _t_step))
