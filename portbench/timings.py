"""What the program's own tracer says of each window slide.

``status["timings"]`` (``digipathai_tpu_torch/utils/profiling.py``,
``StageTimer.summary``) holds each span name's seconds in the call,
summed over threads, and ``counters``; ``run.py`` keeps it per slide.  A
program without the spans read leaves them out, and these helpers return
None.
"""

from __future__ import annotations


def _timings(ctx):
    return [(s.get("timings") or {}, s["wall"]) for s in ctx.slides]


def mean_seconds(ctx, names):
    """Mean over the window's slides of the spans ``names``' seconds."""
    vals = [sum(t.get(n, 0.0) for n in names)
            for t, _ in _timings(ctx) if any(n in t for n in names)]
    return sum(vals) / len(vals) if vals else None


def mean_share(ctx, names):
    """Mean over the window's slides of the spans ``names``' seconds over
    the slide's wall, in percent."""
    vals = [100.0 * sum(t.get(n, 0.0) for n in names) / wall
            for t, wall in _timings(ctx) if any(n in t for n in names)]
    return sum(vals) / len(vals) if vals else None


def mean_counter(ctx, name):
    """Mean over the window's slides of the counter ``name``."""
    vals = [t["counters"][name] for t, _ in _timings(ctx)
            if name in (t.get("counters") or {})]
    return sum(vals) / len(vals) if vals else None
