"""Bounded-window host-to-device streaming: the port of
``fastdfs_tpu/ops/streaming.py``.

Sustained throughput needs the host-to-device copy of batch ``i + 1`` to
overlap the device work on batch ``i``.  Each batch goes to the card
through pinned memory with ``non_blocking=True``, its step is launched,
and its result is copied back into pinned host memory behind it, all on
the current stream and without waiting; an event marks the end of that
batch.  The window keeps up to ``depth`` batches in flight and waits on
the oldest one's event only when the window is full, so a fetch never
waits for batches submitted after it.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from fastdfs_tpu_torch.ops import resolve_device


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """One host array onto ``dev``: through pinned memory, without waiting
    for the copy, when ``dev`` is a card."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _map(fn, result):
    """``fn`` applied to each tensor of a step's result: a tensor, a tuple
    or list of them, or a dict of them (the reference's pytree)."""
    if isinstance(result, torch.Tensor):
        return fn(result)
    if isinstance(result, (tuple, list)):
        return type(result)(_map(fn, r) for r in result)
    if isinstance(result, dict):
        return {key: _map(fn, val) for key, val in result.items()}
    return result


def _copy_back(t: torch.Tensor) -> torch.Tensor:
    """Start copying a card tensor into pinned host memory."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def stream_batches(batches: Iterable[tuple[np.ndarray, np.ndarray]],
                   step_fn: Callable, depth: int = 2,
                   device: str | torch.device = "cuda") -> Iterator[object]:
    """Run ``step_fn(device_batch, device_lens)`` over a host batch stream
    with up to ``depth`` batches in flight; yields results in submission
    order, each tensor of a result as a NumPy array.

    ``step_fn`` launches its device work and returns without waiting for
    it (any PyTorch function of tensors does).  ``device`` is ``cuda``
    unless the caller passes ``cpu``.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = resolve_device(device)
    inflight: deque = deque()

    def fetch():
        result, done = inflight.popleft()
        if done is not None:
            done.synchronize()
        return _map(_numpy, result)

    for batch, lens in batches:
        result = _map(_copy_back, step_fn(_to_device(batch, dev),
                                          _to_device(lens, dev)))
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        inflight.append((result, done))
        if len(inflight) > depth:
            yield fetch()
    while inflight:
        yield fetch()
