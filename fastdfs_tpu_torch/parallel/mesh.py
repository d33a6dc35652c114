"""Mesh construction: factor a device count into (dp, sp, tp) axes.

The port of ``fastdfs_tpu/parallel/mesh.py``.  A ``Mesh`` is a numpy
object array of ``torch.device``s shaped by the axis sizes, inside one
process; rank ``r`` is the ``r``-th device in row-major order, as in a
``jax.sharding.Mesh``.  A device may stand at several ranks: that is how
the CPU tests (``["cpu"] * 8``) and a one-card host (``[cuda:0] * 8``)
run a (2, 2, 2) mesh.  Nothing places several ranks on one device unless
the caller passes such a list.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdfs_tpu_torch.ops import resolve_device


def factorize_devices(n: int, num_axes: int = 3) -> tuple[int, ...]:
    """Split ``n`` devices into ``num_axes`` near-equal power factors.

    8 → (2, 2, 2); 4 → (2, 2, 1); 2 → (2, 1, 1); 1 → (1, 1, 1);
    6 → (3, 2, 1); 12 → (3, 2, 2).  Earlier axes get the larger factors
    (dp first: chunk batches are the abundant parallelism).
    """
    factors = []
    rem = n
    for d in range(2, rem + 1):
        while rem % d == 0:
            factors.append(d)
            rem //= d
    factors.sort(reverse=True)
    axes = [1] * num_axes
    for f in factors:
        axes[int(np.argmin(axes))] *= f
    return tuple(sorted(axes, reverse=True))


def cuda_devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` visible CUDA cards (all of them if ``n`` is None);
    asking for more than are visible raises."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name in ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)

    def device(self, rank: int) -> torch.device:
        return self.devices.flat[rank]

    def coords(self, rank: int) -> dict[str, int]:
        """Rank -> its index on each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(rank, self.devices.shape)))

    def groups(self, axis: str) -> np.ndarray:
        """Ranks that differ only along ``axis``: int array
        ``(size // shape[axis], shape[axis])``, each row in axis order."""
        ranks = np.arange(self.size).reshape(self.devices.shape)
        ax = self.axis_names.index(axis)
        return np.moveaxis(ranks, ax, -1).reshape(-1, self.shape[axis])


def _mesh(devs: list[torch.device], shape: tuple[int, ...],
          axis_names: tuple[str, ...]) -> Mesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


def _devices(n: int | None, devices) -> list[torch.device]:
    if devices is None:
        return cuda_devices(n)
    devs = [resolve_device(d) for d in devices]
    n = len(devs) if n is None else n
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("dp", "sp", "tp"),
              devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA cards), factored by ``factorize_devices``."""
    devs = _devices(n_devices, devices)
    return _mesh(devs, factorize_devices(len(devs), len(axis_names)),
                 axis_names)


def fingerprint_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ``dp`` mesh for the fingerprint fan-out (chunk rows are the
    abundant parallelism; no collectives are needed, so one axis is the
    whole story)."""
    devs = _devices(n_devices, devices)
    return _mesh(devs, (len(devs),), ("dp",))
