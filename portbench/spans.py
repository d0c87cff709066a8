"""Spans of the program's stages, recorded from the benchmark's side.

The program times its stages with ``utils/profiling.py::StageTimer``
(``plan``, ``infer``, ``flush``, ``finalize``, ``write``, and more in the
modes no cell runs yet).  ``install`` wraps ``StageTimer.stage`` so that every stage
opened on the main thread is also kept in a ``Recorder`` as (name, start,
end) on the ``time.monotonic`` clock and, while a ``torch.profiler``
window is open, marked in it as ``stage:<name>``; stages of other
threads are left to the program's own sums.  The
program is not changed: its timer's sums stay as they were.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Recorder:
    """The main thread's stage spans since the last ``take``."""

    def __init__(self):
        self.spans = []

    def take(self) -> list:
        out, self.spans = self.spans, []
        return out


def install(recorder: Recorder) -> None:
    """Wrap ``StageTimer.stage`` for the rest of the process so that main-
    thread stages also land in ``recorder``."""
    import torch
    from digipathai_tpu_torch.utils.profiling import StageTimer

    inner = getattr(StageTimer.stage, "_portbench_inner", StageTimer.stage)

    @contextmanager
    def stage(self, name):
        if threading.current_thread() is not threading.main_thread():
            with inner(self, name):
                yield
            return
        t0 = time.monotonic()
        try:
            with torch.profiler.record_function(f"stage:{name}"), \
                    inner(self, name):
                yield
        finally:
            recorder.spans.append((name, t0, time.monotonic()))

    stage._portbench_inner = inner
    StageTimer.stage = stage

