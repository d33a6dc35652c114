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


def kernel_device_ms(fn, kernels: dict[str, str], calls: int = 5,
                     tries: int = 5) -> dict[str, float] | None:
    """Device ms of one call of ``fn`` under torch.profiler, over
    ``calls`` calls after a warm-up call: for each label of ``kernels``,
    the mean time of the device kernels whose names hold its value (each
    runs once a call), and under ``"all"`` every device kernel, memset
    and copy of the calls, summed and divided by ``calls``.  The profiler
    drops one of a run's device events now and then, so a run counts only
    where each named kernel shows at least half the calls; after
    ``tries`` runs without one, None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        out = {}
        for label, name in kernels.items():
            hits = [ev for ev in events if name in ev.key]
            if not hits or 2 * sum(ev.count for ev in hits) < calls:
                break
            out[label] = sum(ev.self_device_time_total / ev.count
                             for ev in hits) / 1e3
        else:
            out["all"] = sum(ev.self_device_time_total
                             for ev in events) / calls / 1e3
            return out
    return None
