#!/usr/bin/env python3
"""What a span of ``digipathai_tpu_torch``'s tracer costs.

    python3 tools/tracer_cost_torch.py [--spans 20000] [--repeats 5]

Times ``StageTimer.stage`` opened and closed back to back on the host:
with no profiler running, under a running ``torch.profiler`` (CPU and,
where there is a card, CUDA activities) on the thread that made the timer
(a ``stage:`` range each), and under it on another thread (no range).
Prints one JSON line: the microseconds per span of each, the best of
``--repeats``, and the device the profiler watched.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def per_span_us(timer, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with timer.stage("span"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def on_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), name="flusher_0")
    t.start()
    t.join()
    return out[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from digipathai_tpu_torch.utils.profiling import StageTimer

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n = args.spans
    off, main_on, thread_on = [], [], []
    for _ in range(args.repeats):
        off.append(per_span_us(StageTimer(), n))
        with profile(activities=acts):
            main_on.append(per_span_us(StageTimer(), n))
            timer = StageTimer()
            thread_on.append(on_thread(lambda: per_span_us(timer, n)))
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else "cpu"),
        "spans": n,
        "us_per_span_off": min(off),
        "us_per_span_profiled_main": min(main_on),
        "us_per_span_profiled_other_thread": min(thread_on),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
