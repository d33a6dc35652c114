"""Timing on the CUDA card: CUDA-event medians and the card's name and
power limit, as ``nvidia-smi`` reports them, to stand beside every
time."""

from __future__ import annotations

import statistics
import subprocess

import torch


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def once_ms(fn):
    """``(fn(), ms)``: one call timed by CUDA events on the current
    stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, n: int = 20) -> float:
    """Median ms of ``n`` calls after one warm-up call (CUDA events)."""
    fn()
    return statistics.median(once_ms(fn)[1] for _ in range(n))
