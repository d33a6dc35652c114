"""Collectives over a ``Mesh`` inside one process.

Each function takes one tensor per rank, in mesh order (``xs[r]`` lies on
``mesh.device(r)``), and returns one tensor per rank, on that rank's
device.  They stand in for the ``jax.lax`` collectives that the JAX
package's ``shard_map`` steps call:

    ppermute   -> a copy to the receiving rank's device
    all_gather -> torch.cat on each receiving rank's device
    pmax       -> an element-wise max on each receiving rank's device

All work runs on each device's current stream.  A copy between two CUDA
devices waits for the source's current stream and makes the
destination's current stream wait for it, so no extra events are
needed; a rank whose device equals the sender's gets the sender's tensor
itself (no copy), which is why nothing here writes to its inputs or
outputs in place.  Ranks on side streams would need an event wait and
``record_stream`` for every cross-rank copy.
"""

from __future__ import annotations

import torch

from fastdfs_tpu_torch.parallel.mesh import Mesh


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def ppermute(mesh: Mesh, xs: list[torch.Tensor], axis: str,
             perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Within each group along ``axis``, index ``src`` sends to index
    ``dst`` for each ``(src, dst)`` in ``perm``; a rank that receives
    nothing gets zeros, as in ``jax.lax.ppermute``."""
    out: list[torch.Tensor | None] = [None] * mesh.size
    for group in mesh.groups(axis):
        for src, dst in perm:
            r = group[dst]
            out[r] = _to(xs[group[src]], mesh.device(r))
    return [x if x is not None else torch.zeros_like(xs[r])
            for r, x in enumerate(out)]


def all_gather(mesh: Mesh, xs: list[torch.Tensor], axis: str,
               dim: int) -> list[torch.Tensor]:
    """Every rank gets its group's tensors concatenated along ``dim``, in
    axis order (``jax.lax.all_gather(..., tiled=True)``)."""
    out: list[torch.Tensor | None] = [None] * mesh.size
    for group in mesh.groups(axis):
        for r in group:
            dev = mesh.device(r)
            out[r] = torch.cat([_to(xs[s], dev) for s in group], dim=dim)
    return out


def pmax(mesh: Mesh, xs: list[torch.Tensor], axis: str
         ) -> list[torch.Tensor]:
    """Every rank gets the element-wise max over its group."""
    out: list[torch.Tensor | None] = [None] * mesh.size
    for group in mesh.groups(axis):
        for r in group:
            dev = mesh.device(r)
            best = _to(xs[group[0]], dev)
            for s in group[1:]:
                best = torch.maximum(best, _to(xs[s], dev))
            out[r] = best
    return out
