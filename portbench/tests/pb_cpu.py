"""Runs of a cell on the CPU for the benchmark's tests: small segments,
and the engine's two kernel wrappers replaced by the plain reference, so
that the engine's own staging, chunk table, ordering and unpacking run
around fast stand-ins (the plain twins take seconds a megabyte)."""

from __future__ import annotations

import numpy as np
import torch

import fastdfs_tpu_torch.dedup.engine as engine_mod
from portbench import manifest, reference, run


def sha1_stand_in(seg, offsets, lens, order=None, out=None, row_tile=256):
    words = reference.sha1_words(seg.numpy().tobytes(), offsets.numpy(),
                                 lens.numpy().astype(np.int64))
    out.copy_(torch.from_numpy(words.view(np.int32)))
    return out.view(torch.uint32)


def sketch_stand_in(seg, offsets, lens, words=None, order=None, out=None,
                    row_tile=256, k=reference.SHINGLE, with_z=False):
    lens = lens.numpy().astype(np.int64)
    key, val = reference.survivors(seg.numpy(), offsets.numpy(), lens, k)
    a, b = reference.perm_constants(out.shape[1])
    sig = reference.signatures(key, val, len(lens), a, b)
    out.copy_(torch.from_numpy(sig.view(np.int32)))
    return out.view(torch.uint32)


def patch_kernels(monkeypatch, sha1=sha1_stand_in, sketch=sketch_stand_in):
    monkeypatch.setattr(engine_mod, "sha1_ragged_cuda", sha1)
    monkeypatch.setattr(engine_mod, "sketch_ragged_cuda", sketch)


def small_cell(name: str, segment_bytes: int = 1 << 18,
               segments: int = 3) -> manifest.Cell:
    """``name`` at small segments, with its deployment's streams."""
    cell = manifest.cell(name)
    cell.traffic = dict(cell.traffic, segment_bytes=segment_bytes)
    cell.config = dict(cell.config, corpus_bytes=segments * segment_bytes)
    return cell


def run_cpu(cell: manifest.Cell, seed: int, seconds: float = 1.0,
            system=None, traced: bool = False) -> dict:
    result, _ = run.run_cell(cell, seed, seconds, traced,
                             torch.device("cpu"), system=system,
                             log=lambda msg: None)
    return result
