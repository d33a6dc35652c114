"""The distributed ingest step and the fingerprint fan-out, over a ``Mesh``.

The port of ``fastdfs_tpu/parallel/ingest_step.py``.  The reference runs
one jitted ``shard_map``; here every rank of the mesh runs the same body
on its shard, inside one process, and the collectives of
``parallel.collectives`` join them.  The stages of ``make_ingest_step``:

1. **CDC, sequence-parallel (sp)**: each rank holds one contiguous block
   of every stream.  The gear hash's 32-byte window straddles block
   seams, so each rank sends the gear values of its trailing 31 bytes to
   the next rank along ``sp`` (``ppermute``); the first block's halo is
   zero values (not zero bytes: byte 0 has gear value ``fmix32(1)``).
   The gear kernel's dense form (``block_candidates_cuda``) hashes the
   block after its halo.
2. **SHA-1, data-parallel (dp)**: rows shard over ``dp``; each rank runs
   the SHA-1 kernel (``sha1_batch_cuda``) on its rows, then the digests
   are all-gathered along ``dp``.
3. **MinHash, tensor-parallel (tp)**: each rank runs MinHash stages 1-3
   through the sketch kernels (``survivor_segmin_cuda``: the k = 5
   kernel's ``z`` at shingle 5, the general kernel's ``z`` form at any
   other width) and stage 4 for its ``P / tp`` permutations through the
   stage-4 kernel (``signature_tiles_cuda``, given the rank's columns of
   the permutation words); signatures are all-gathered along ``tp``, then
   along ``dp``.  With ``tp == 1`` and 64 permutations one launch of the
   fused sketch (``minhash_batch_cuda``) signs the rows whole, at any
   shingle width.
4. **Index query (dp + pmax)**: the signature index is row-sharded over
   ``dp``; each rank scores the gathered signatures against its shard
   through the index kernel (``index_best_cuda``) and the best
   similarity is reduced with ``pmax``.

Every rank runs the whole body, as ``shard_map`` does: ranks that differ
only in ``sp`` or ``tp`` hash the same rows (stages 2-3 run ``sp * tp``
times per row).  ``make_fingerprint_step`` is the fan-out with no
collectives: rows shard over a 1-D ``dp`` mesh, each rank runs both
kernels on its rows.

On CPU ranks every kernel wrapper takes its plain twin; on CUDA ranks it
launches its kernel or raises, at every shingle width.  The plain twins
of stages 1 and 4, ``block_candidates`` (from ``ops.gear_cdc``) and
``index_best`` (from ``ops.cuda_index``), and ``fingerprint_mesh`` (from
``parallel.mesh``, where the reference defines it in this module) stay
importable from here.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdfs_tpu_torch.ops.cuda_gear import block_candidates_cuda
from fastdfs_tpu_torch.ops.cuda_index import (  # noqa: F401 (re-export)
    index_best, index_best_cuda)
from fastdfs_tpu_torch.ops.cuda_minhash import (KERNEL_PERMS,
                                                minhash_batch_cuda,
                                                signature_tiles_cuda,
                                                survivor_segmin_cuda)
from fastdfs_tpu_torch.ops.cuda_sha1 import sha1_batch_cuda
from fastdfs_tpu_torch.ops.gear_cdc import (  # noqa: F401 (re-export)
    WINDOW, block_candidates, gear_values)
from fastdfs_tpu_torch.ops.minhash import perm_words
from fastdfs_tpu_torch.parallel.collectives import all_gather, pmax, ppermute
from fastdfs_tpu_torch.parallel.mesh import (  # noqa: F401 (re-export)
    Mesh, fingerprint_mesh)

HALO = WINDOW - 1

_NUMPY = {torch.uint8: np.uint8, torch.int32: np.int32}


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """An array or tensor as a tensor of ``dtype``: uint8 bytes, int32
    lengths, or uint32 words carried as their int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        if x.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {x.dtype}")
        return x
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=_NUMPY[dtype]))


def _shard(mesh: Mesh, x: torch.Tensor, spec: tuple[str | None, ...]
           ) -> list[torch.Tensor]:
    """``x`` split as a ``PartitionSpec`` splits it: dimension ``d`` into
    ``mesh.shape[spec[d]]`` equal blocks (whole where ``spec[d]`` is
    None), each rank's block on its device.  Ranks that share a device
    and a block share one tensor."""
    placed: dict = {}
    out = []
    for r in range(mesh.size):
        coords = mesh.coords(r)
        idx = []
        for d, axis in enumerate(spec):
            if axis is None:
                idx.append(slice(None))
                continue
            k = mesh.shape[axis]
            if x.shape[d] % k:
                raise ValueError(f"dimension {d} of shape {tuple(x.shape)} "
                                 f"does not divide by {axis} = {k}")
            step = x.shape[d] // k
            idx.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
        dev = mesh.device(r)
        key = (dev, tuple((s.start, s.stop) for s in idx))
        if key not in placed:
            placed[key] = x[tuple(idx)].to(dev, non_blocking=True)
        out.append(placed[key])
    return out


def _rank_perms(mesh: Mesh, num_perms: int, tp: int) -> list:
    """Each rank's stage-4 constants: the int32 ``(2, P / tp)`` words of
    the permutations of its ``tp`` index, on its device (one copy per
    device and index)."""
    p_local = num_perms // tp
    built: dict = {}
    out = []
    for r in range(mesh.size):
        t = mesh.coords(r).get("tp", 0)
        key = (mesh.device(r), t)
        if key not in built:
            words = perm_words(num_perms, mesh.device(r))
            built[key] = words[:, t * p_local:(t + 1) * p_local].contiguous()
        out.append(built[key])
    return out


def _sign_rows(rows: torch.Tensor, lens: torch.Tensor, shingle: int,
               words) -> torch.Tensor:
    """int32 bits of the MinHash signatures of padded rows at width
    ``shingle``: the fused sketch when ``words`` is None (all 64
    permutations), else kernel stages 1-3 and the stage-4 kernel over the
    permutation ``words``."""
    if words is None:
        return minhash_batch_cuda(rows, lens, KERNEL_PERMS,
                                  shingle).view(torch.int32)
    z = survivor_segmin_cuda(rows, lens, shingle)
    return signature_tiles_cuda(z, words).view(torch.int32)


class IngestStep:
    """The distributed ingest step for one mesh (``make_ingest_step``).

    ``step(stream, chunk_batch, chunk_lens, index_sigs)`` takes

    - ``stream``: uint8 ``(B, sp, block_len)``: B byte streams, each split
      into ``sp`` contiguous blocks;
    - ``chunk_batch``: uint8 ``(N, L)`` rows zero past their int32
      ``chunk_lens`` ``(N,)``;
    - ``index_sigs``: uint32 ``(M, num_perms)``, the near-dup index rows
      (M across dp);

    as arrays or tensors on any device, and returns ``(cand (B, sp,
    block_len) bool, digests (N, 5) uint32, sigs (N, num_perms) uint32,
    best (N,) float32)`` on rank 0's device.  ``B``, ``N`` and ``M`` must
    divide by dp.  ``per_rank`` returns every rank's own outputs and
    ``assemble`` puts them together as the step does.
    """

    def __init__(self, mesh: Mesh, num_perms: int = 64, avg_bits: int = 13,
                 shingle: int = 5) -> None:
        tp = mesh.shape["tp"]
        if num_perms % tp:
            raise ValueError(f"num_perms {num_perms} must divide by tp {tp}")
        self.mesh = mesh
        self.num_perms = num_perms
        self.avg_bits = avg_bits
        self.shingle = shingle
        fused = tp == 1 and num_perms == KERNEL_PERMS
        self._perms = ([None] * mesh.size if fused
                       else _rank_perms(mesh, num_perms, tp))

    def per_rank(self, stream, chunk_batch, chunk_lens, index_sigs
                 ) -> list[tuple[torch.Tensor, ...]]:
        """Each rank's ``(cand (B/dp, 1, block_len), digests, sigs, best)``,
        on its device; digests and sigs as int32 bits."""
        mesh = self.mesh
        sp = mesh.shape["sp"]
        stream = _tensor(stream, torch.uint8)
        if stream.ndim != 3 or stream.shape[1] != sp:
            raise ValueError(f"stream must be (B, sp={sp}, block_len), got "
                             f"{tuple(stream.shape)}")
        if sp > 1 and stream.shape[2] < HALO:
            raise ValueError(f"blocks of {stream.shape[2]} bytes are shorter "
                             f"than the {HALO}-byte halo")
        blocks = _shard(mesh, stream, ("dp", "sp", None))
        rows = _shard(mesh, _tensor(chunk_batch, torch.uint8), ("dp", None))
        lens = _shard(mesh, _tensor(chunk_lens, torch.int32), ("dp",))
        index = _shard(mesh, _tensor(index_sigs, torch.int32), ("dp", None))
        ranks = range(mesh.size)

        # Stage 1: sequence-parallel CDC with the ring halo exchange: only
        # the gear values of each block's trailing 31 bytes travel.
        rows_sp = [b[:, 0, :] for b in blocks]
        prev = ppermute(mesh, [gear_values(x[:, -HALO:]) for x in rows_sp],
                        "sp", [(i, (i + 1) % sp) for i in range(sp)])
        cand = []
        for r in ranks:
            x = rows_sp[r]
            halo = (prev[r] if mesh.coords(r)["sp"] else
                    torch.zeros((x.shape[0], HALO), dtype=torch.int64,
                                device=x.device))
            cand.append(block_candidates_cuda(x, halo, self.avg_bits)[:, None])

        # Stage 2: data-parallel SHA-1 and the digest all-gather.
        digests = all_gather(mesh, [sha1_batch_cuda(rows[r], lens[r])
                                    .view(torch.int32) for r in ranks],
                             "dp", 0)

        # Stage 3: tensor-parallel MinHash, gathered on tp, then on dp.
        sigs = [_sign_rows(rows[r], lens[r], self.shingle, self._perms[r])
                for r in ranks]
        sigs = all_gather(mesh, all_gather(mesh, sigs, "tp", 1), "dp", 0)

        # Stage 4: dp-sharded index query and the global max.
        best = pmax(mesh, [index_best_cuda(sigs[r], index[r]) for r in ranks],
                    "dp")
        return list(zip(cand, digests, sigs, best))

    def __call__(self, stream, chunk_batch, chunk_lens, index_sigs):
        return self.assemble(self.per_rank(stream, chunk_batch, chunk_lens,
                                           index_sigs))

    def assemble(self, outs: list[tuple[torch.Tensor, ...]]):
        """``per_rank``'s outputs as the step returns them: ``cand`` put
        together from the (dp, sp) ranks, the replicated outputs taken
        from rank 0."""
        mesh = self.mesh
        dev = mesh.device(0)
        b_loc, _, blk = outs[0][0].shape
        cand = torch.empty((b_loc * mesh.shape["dp"], mesh.shape["sp"], blk),
                           dtype=torch.bool, device=dev)
        for r, out in enumerate(outs):
            c = mesh.coords(r)
            if c["tp"] == 0:
                d, s = c["dp"], c["sp"]
                cand[d * b_loc:(d + 1) * b_loc, s:s + 1] = out[0].to(dev)
        _, digests, sigs, best = outs[0]
        return (cand, digests.view(torch.uint32), sigs.view(torch.uint32),
                best)


def make_ingest_step(mesh: Mesh, num_perms: int = 64, avg_bits: int = 13,
                     shingle: int = 5) -> IngestStep:
    """The distributed ingest step for ``mesh`` (see ``IngestStep``)."""
    return IngestStep(mesh, num_perms, avg_bits, shingle)


def distributed_ingest_step(mesh: Mesh, stream, chunk_batch, chunk_lens,
                            index_sigs, num_perms: int = 64,
                            avg_bits: int = 13, shingle: int = 5):
    """Build the step for ``mesh`` and run it once."""
    return make_ingest_step(mesh, num_perms, avg_bits, shingle)(
        stream, chunk_batch, chunk_lens, index_sigs)


def make_fingerprint_step(mesh: Mesh, num_perms: int = 64,
                          shingle: int = 5):
    """The fingerprint fan-out over a 1-D ``dp`` mesh.

    Returns ``step(chunk_batch (N, L) uint8, chunk_lens (N,) int32) ->
    (digests (N, 5) uint32, sigs (N, num_perms) uint32)`` on rank 0's
    device, in row order.  ``N`` must divide by the mesh's size.  Each
    rank runs the SHA-1 kernel and the sketch kernel (fused with stage 4
    for 64 permutations, else followed by the stage-4 kernel)
    on its rows: no collectives, one launch of each kernel per rank.
    """
    if mesh.axis_names != ("dp",):
        raise ValueError(f"a fingerprint mesh has the one axis dp, not "
                         f"{mesh.axis_names}")
    fused = num_perms == KERNEL_PERMS
    perms = ([None] * mesh.size if fused
             else _rank_perms(mesh, num_perms, 1))
    dev = mesh.device(0)

    def step(chunk_batch, chunk_lens):
        rows = _shard(mesh, _tensor(chunk_batch, torch.uint8), ("dp", None))
        lens = _shard(mesh, _tensor(chunk_lens, torch.int32), ("dp",))
        digests, sigs = [], []
        for r in range(mesh.size):
            digests.append(sha1_batch_cuda(rows[r], lens[r]).view(torch.int32))
            sigs.append(_sign_rows(rows[r], lens[r], shingle, perms[r]))
        return tuple(torch.cat([x.to(dev) for x in xs]).view(torch.uint32)
                     for xs in (digests, sigs))

    return step


def distributed_fingerprint(mesh: Mesh, chunk_batch, chunk_lens,
                            num_perms: int = 64, shingle: int = 5):
    """Build the fan-out step for ``mesh`` and run it once."""
    return make_fingerprint_step(mesh, num_perms, shingle)(chunk_batch,
                                                           chunk_lens)
