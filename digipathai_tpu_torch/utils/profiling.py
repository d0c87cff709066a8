"""Spans, counters and the profiler hook of one segmentation call.

``StageTimer`` is the one tracer of a call.  Each ``stage(name)`` records
a ``Span``: its name, the role of the thread that opened it (``main`` for
the thread that made the timer, else the thread's name without its pool
index, such as ``flusher``), start and end on ``time.monotonic()``, and
its parent, the span open on the same thread.  While a ``torch.profiler``
runs, a span the main thread opens is also a ``stage:<name>`` range in
the profiler's trace, so the device work lines up under it; the other
threads' spans stay out of that trace, where they would overlap the main
thread's.  ``count(name, n)`` adds to a counter.  ``summary()`` is what
``status["timings"]`` carries: seconds per span name, summed over
threads, ``total`` from ``start()`` to now, and ``counters``.

``maybe_profile`` traces with ``torch.profiler`` when ``DPAI_PROFILE_DIR``
is set and no profiler runs already, the same switch as the JAX version,
and writes ``<dir>/<name>.json`` (a Chrome trace of host and device
activity).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "StageTimer", "maybe_profile"]


def _profiler_running() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


@dataclass(slots=True)
class Span:
    name: str
    role: str
    start: float
    parent: Optional[int]  # index of the enclosing span in ``spans``
    end: Optional[float] = None  # None while the span is open


class StageTimer:
    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._main = threading.get_ident()
        self._open = threading.local()  # each thread's stack of open spans
        self._t0 = time.monotonic()

    def start(self):
        """Count ``summary()["total"]`` from now on."""
        self._t0 = time.monotonic()

    @contextmanager
    def stage(self, name: str):
        main = threading.get_ident() == self._main
        role = ("main" if main
                else threading.current_thread().name.rsplit("_", 1)[0])
        stack = self._open.__dict__.setdefault("stack", [])
        mark = (torch.profiler.record_function(f"stage:{name}")
                if main and _profiler_running() else nullcontext())
        with mark:
            with self._lock:
                i = len(self.spans)
                span = Span(name, role, time.monotonic(),
                            stack[-1] if stack else None)
                self.spans.append(span)
            stack.append(i)
            try:
                yield
            finally:
                stack.pop()
                end = time.monotonic()
                with self._lock:
                    span.end = end

    def count(self, name: str, n: int):
        with self._lock:
            self.counters[name] += n

    def summary(self) -> dict:
        sums: Dict[str, float] = defaultdict(float)
        with self._lock:
            for s in self.spans:
                if s.end is not None:
                    sums[s.name] += s.end - s.start
            counters = dict(sorted(self.counters.items()))
        out = {k: round(v, 3) for k, v in sorted(sums.items())}
        out["total"] = round(time.monotonic() - self._t0, 3)
        out["counters"] = counters
        return out


@contextmanager
def maybe_profile(name: str = "dpai"):
    trace_dir = os.environ.get("DPAI_PROFILE_DIR")
    if not trace_dir or _profiler_running():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
