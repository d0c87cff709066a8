#!/usr/bin/env python3
"""Where one benchmark cell's time falls outside the program's spans.

    python3 tools/span_gaps_torch.py --workload dense-patch-resection \
        --seed 7 [--seconds 10]

from the repository's root, on a machine with a card.  Runs the cell
traced as ``portbench/run.py --trace 1`` does and prints one JSON line:

- ``main_gaps_ms``: over the window's slides after the first, the median
  milliseconds between consecutive top-level main-thread spans of a
  ``getSegmentation`` call, keyed ``<span before>-><span after>``
  (``call-start`` and ``call-end`` for the call's own bounds), the
  longest first; ``outside_ms`` sums them;
- ``idle_by_label_s``: every idle stretch of the traced slide's device
  summed by the stage that holds it (the result line keeps only the ten
  longest), ``no stage`` for the time outside every stage.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import digipathai_tpu_torch.engine.segmentation as seg
    from digipathai_tpu_torch.utils import profiling
    from portbench import run, trace

    timers, calls, idle = [], [], []

    class Kept(profiling.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    segment = seg.getSegmentation

    def timed(*a, **kw):
        t0 = time.monotonic()
        try:
            return segment(*a, **kw)
        finally:
            calls.append((t0, time.monotonic()))

    idle_gaps = trace.Trace.idle_gaps

    def kept_gaps(self):
        gaps = idle_gaps(self)
        idle.extend(gaps)
        return gaps

    seg.StageTimer = Kept
    seg.getSegmentation = timed
    trace.Trace.idle_gaps = kept_gaps
    result = run.run(args.workload, args.seed, args.seconds, True, "cuda:0")

    # the warm-up call first, the traced slide last: the window between
    per = {}
    for timer, (a, b) in list(zip(timers, calls))[1:-1]:
        # an engine without spans (before its tracer kept them) has none
        tops = sorted((s for s in getattr(timer, "spans", ())
                       if s.role == "main" and s.parent is None),
                      key=lambda s: s.start)
        prev, end, seen = "call-start", a, {}
        for s in tops + [None]:
            key = f"{prev}->{s.name if s else 'call-end'}"
            seen[key] = seen.get(key, 0.0) + ((s.start if s else b) - end)
            if s:
                prev, end = s.name, s.end
        for k, v in seen.items():
            per.setdefault(k, []).append(v)
    gaps = {k: 1e3 * statistics.median(v) for k, v in per.items()}
    by_label = {}
    for name, s in idle:
        by_label[name] = by_label.get(name, 0.0) + s
    print(json.dumps({
        "workload": args.workload, "correct": result["correct"],
        "device": result["device"],
        "slides": len(calls) - 2,
        "outside_ms": sum(gaps.values()),
        "main_gaps_ms": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "idle_by_label_s": dict(sorted(by_label.items(),
                                       key=lambda kv: -kv[1])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
