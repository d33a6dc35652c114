"""The device trace of a ``--trace 1`` run, reduced.

``torch.profiler`` records the window (CPU and CUDA activity).  This
module reads its raw events once: every device operation (kernels,
copies, memsets) and every host operation, with start and end on one
clock, and the window's own span, which the harness records around the
window.  From them:

- ``busy_s``: the union of device operations inside the window;
- ``ops(part)``: the count and seconds of device operations whose name
  holds ``part``;
- ``device_ops()``: seconds by device operation, most first;
- ``idle_gaps()``: the longest stretches of the window with no device
  operation, each named by the device operation before it and the host
  operation that overlapped it most (``host outside torch calls`` where
  none did).
"""

from __future__ import annotations

import numpy as np

WINDOW_SPAN = "portbench.window"


def short_name(name: str) -> str:
    """A device operation's name without its argument list, template
    arguments or namespaces, spaces as underscores:
    ``(anonymous namespace)::sha1_ragged_kernel(...)`` is
    ``sha1_ragged_kernel``, ``Memcpy HtoD (Pinned -> Device)`` is
    ``Memcpy_HtoD``."""
    base = name
    if base.endswith(")"):
        depth = 0
        for i in range(len(base) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(base[i], 0)
            if depth == 0:
                base = base[:i]
                break
    base = base.split("<")[0]
    if "::" in base:
        base = base.rsplit("::", 1)[1]
    return (base.strip() or name).replace(" ", "_")


class Trace:
    def __init__(self, device: list[tuple[str, int, int]],
                 host: list[tuple[str, int, int]], window: tuple[int, int]):
        self.window = window
        w0, w1 = window
        dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device
               if b > w0 and a < w1]
        dev.sort(key=lambda e: e[1])
        self.device = dev
        self.host = host
        self.window_s = (w1 - w0) / 1e9
        self._busy = self._merge()

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        results = prof.profiler.kineto_results
        device, host, window = [], [], None
        for ev in results.events():
            name = ev.name()
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if str(ev.device_type()).endswith("CUDA"):
                device.append((name, start, end))
            elif name == WINDOW_SPAN:
                window = (start, end)
            else:
                host.append((name, start, end))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        return cls(device, host, window)

    def _merge(self) -> list[tuple[int, int]]:
        spans = []
        for _, a, b in self.device:
            if spans and a <= spans[-1][1]:
                if b > spans[-1][1]:
                    spans[-1][1] = b
            else:
                spans.append([a, b])
        return [tuple(s) for s in spans]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e9

    def ops(self, part: str) -> tuple[int, float]:
        hits = [b - a for n, a, b in self.device if part in n]
        return len(hits), sum(hits) / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        by = {}
        for n, a, b in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _gaps(self) -> list[tuple[int, int, str]]:
        w0, w1 = self.window
        gaps, at, before = [], w0, "window_start"
        ends = {}
        for n, a, b in self.device:
            ends[b] = n
        for a, b in self._busy:
            if a > at:
                gaps.append((at, a, before))
            at = b
            before = short_name(ends.get(b, "device_op"))
        if w1 > at:
            gaps.append((at, w1, before))
        return gaps

    def idle_gaps(self, top: int = 10) -> list[list]:
        gaps = sorted(self._gaps(), key=lambda g: g[0] - g[1])[:top]
        if self.host:
            names = [n for n, _, _ in self.host]
            hs = np.array([a for _, a, _ in self.host], dtype=np.int64)
            he = np.array([b for _, _, b in self.host], dtype=np.int64)
        out = []
        for a, b, before in gaps:
            what = "host outside torch calls"
            if self.host:
                overlap = np.minimum(he, b) - np.maximum(hs, a)
                hit = np.nonzero(overlap > 0)[0]
                if len(hit):
                    by = {}
                    for i in hit.tolist():
                        by[names[i]] = by.get(names[i], 0) + int(overlap[i])
                    what = max(by.items(), key=lambda kv: kv[1])[0]
            out.append([f"after {before}: {what}", (b - a) / 1e9])
        return out
