"""The engine's staging copy: a segment's bytes into its staging buffer,
split over a process-wide pool of host copy threads.

A 64 MiB segment copied by one thread runs at a few GB/s, while the
card's host runs several such copies at once.  ``copy`` splits a segment
of at least ``2 * _SLICE_MIN`` bytes into contiguous slices, one for
each copier (the caller and the pool's threads), and copies them in one
call of the kernel library's ``fdfs_host_copy`` (``csrc/host_copy.cu``),
which releases the interpreter lock once for the whole copy.  There the caller and a pool
of C++ threads, shared by every engine and every calling thread, each
claim the next slice not yet taken, so slices the pool cannot take at
once stay with the caller.  The pool starts on the first copy that
slices, sized from the CPUs the process may run on, capped at
``_MAX_COPIERS``.

Smaller segments are copied inline, as are all segments on a host with
one CPU and all of an engine on the CPU, which has no kernel library
(``native_copy`` gives it none).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from fastdfs_tpu_torch.ops import _build

# A segment of at least twice this many bytes is sliced; slices are at
# least this long.
_SLICE_MIN = 4 << 20
# Copiers of one call at most: the caller and the pool's threads.  About
# four copies at once fill a card host's memory bandwidth; more threads
# only take cores from the calling threads' own work.
_MAX_COPIERS = 4
# Slice boundaries fall on multiples of this many bytes.
_ALIGN = 4096


@functools.cache
def _copiers() -> int:
    return min(len(os.sched_getaffinity(0)), _MAX_COPIERS)


def native_copy(device: torch.device):
    """The sliced copy an engine on ``device`` uses: the kernel library's
    ``fdfs_host_copy`` on a card, none (every copy inline) elsewhere."""
    if device.type != "cuda":
        return None
    return _build.library().fdfs_host_copy


def slice_bytes(n: int) -> int:
    """The length of each slice (the last one shorter) of an ``n``-byte
    segment, or 0 where it is copied inline."""
    k = min(_copiers(), n // _SLICE_MIN)
    if k < 2:
        return 0
    return -(-n // (k * _ALIGN)) * _ALIGN


def copy(dst: np.ndarray, src: np.ndarray, native) -> tuple[int, int]:
    """Copy ``src`` into ``dst[:len(src)]`` (both contiguous ``uint8``),
    in slices over ``native`` (``native_copy``'s answer) when it is given
    and the segment is long enough; returns the number of slices (1:
    inline) and how many of them pool threads copied."""
    n = len(src)
    step = slice_bytes(n) if native is not None else 0
    if not step:
        dst[:n] = src
        return 1, 0
    if (src.dtype != np.uint8 or dst.dtype != np.uint8 or len(dst) < n
            or not (src.flags.c_contiguous and dst.flags.c_contiguous)):
        raise ValueError("copy takes contiguous uint8 arrays, dst at least "
                         "as long as src")
    pooled = native(dst.ctypes.data, src.ctypes.data, n, step,
                    _copiers() - 1)
    return -(-n // step), pooled
