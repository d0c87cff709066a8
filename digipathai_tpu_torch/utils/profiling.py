"""Stage timers and the profiler hook.

``StageTimer`` is a copy of the JAX package's.  ``maybe_profile`` traces
with ``torch.profiler`` when ``DPAI_PROFILE_DIR`` is set, the same switch as
the JAX version, and writes ``<dir>/<name>.json`` (a Chrome trace of host
and device activity).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

__all__ = ["StageTimer", "maybe_profile"]


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.time()

    @contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t
            self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        out = {k: round(v, 3) for k, v in sorted(self.totals.items())}
        out["total"] = round(time.time() - self._t0, 3)
        return out


@contextmanager
def maybe_profile(name: str = "dpai"):
    trace_dir = os.environ.get("DPAI_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
