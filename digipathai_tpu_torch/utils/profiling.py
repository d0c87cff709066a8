"""Stage timers and the profiler hook.

``StageTimer`` is the JAX package's (it loads no jax).  ``maybe_profile``
traces with ``torch.profiler`` when ``DPAI_PROFILE_DIR`` is set, the same
switch as the JAX version, and writes ``<dir>/<name>.json`` (a Chrome
trace of host and device activity).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from digipathai_tpu.utils.profiling import StageTimer

__all__ = ["StageTimer", "maybe_profile"]


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
