"""One slide under ``torch.profiler``, reduced to what the metrics read.

From the profiler's events: every device operation's (name, start, end)
(kernels, copies and sets; the device-side spans of the benchmark's own
``stage:``/``portbench:`` annotations are left out), the main-thread
``stage:<name>`` spans that ``spans.py`` marks, and the window's bounds.
``busy`` merges the operations' intervals (one on any stream counts); an
idle gap is a stretch of the window with nothing running on the device,
cut where a main-thread stage opens or closes and labelled by that stage
(``no stage`` outside them: model build and weight load, and the
harness).
"""

from __future__ import annotations

import time


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(fn):
    """Run ``fn()`` under the profiler; returns (its result, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench:window"):
            t0 = time.monotonic()
            result = fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    return result, Trace(prof.events(), wall)


class Trace:
    def __init__(self, events, wall):
        from torch.autograd import DeviceType

        self.kernels, self.stages = [], []
        self.start = self.end = None
        for e in events:
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            ours = e.name.startswith(("stage:", "portbench:"))
            if e.device_type == DeviceType.CUDA:
                if not ours:
                    self.kernels.append((e.name, a, b))
            elif e.name == "portbench:window":
                self.start, self.end = a, b
            elif e.name.startswith("stage:"):
                self.stages.append((e.name[6:], a, b))
        if self.start is None:
            self.start = min((k[1] for k in self.kernels), default=0.0)
            self.end = self.start + wall
        self.wall = wall
        self.busy = _merge((a, b) for _, a, b in self.kernels)

    def busy_s(self) -> float:
        return sum(min(b, self.end) - max(a, self.start)
                   for a, b in self.busy if b > self.start and a < self.end)

    def kernel_seconds(self) -> dict:
        out = {}
        for name, a, b in self.kernels:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def idle_gaps(self) -> list:
        """[(stage, seconds)] of every stretch with nothing running on the
        device, cut at the main-thread stages' bounds."""
        cuts = sorted({self.start, self.end} | {
            t for _, a, b in self.stages for t in (a, b)
            if self.start < t < self.end})
        idle, t = [], self.start
        for a, b in self.busy + [[self.end, self.end]]:
            if a > t:
                idle.append((t, min(a, self.end)))
            t = max(t, b)
        gaps = []
        for a, b in idle:
            inner = [c for c in cuts if a < c < b]
            for lo, hi in zip([a] + inner, inner + [b]):
                mid = 0.5 * (lo + hi)
                name = next((n for n, s0, s1 in self.stages
                             if s0 <= mid < s1), "no stage")
                gaps.append((name, hi - lo))
        return [g for g in gaps if g[1] > 0]
