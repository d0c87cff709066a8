"""The port's tracer (``utils/profiling.py``) and the benchmark's readers
of it: the spans and the byte counter of one patch-mode call on the tiny
slide, the ``stage:`` ranges a ``torch.profiler`` sees, the lock under
eight threads, and each reader on a hand-built context."""

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from digipathai_tpu_torch.utils import profiling

KW = dict(patch_size=128, stride_size=128, batch_size=8, mode="breast",
          supertile=1024, num_workers=2, model="oracle", device="cpu")
#: the spans a patch-mode call opens besides the stages it had before
NEW_SPANS = ("build", "load", "to_device", "open", "maps", "loader_wait",
             "flush_wait", "finalize.sync", "write.quantize", "write.sync",
             "write.pyramid", "flush.fetch", "flush.accumulate", "flush.state")
WEIGHTS = ("build", "load", "to_device")


def _segment(slide, out: Path, monkeypatch):
    """One call on ``slide`` with its own cache; returns (status, wall,
    the call's timer, [(file replaced, bytes)], output paths)."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.engine import segmentation as seg

    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(out / "cache"))
    timers, replaced = [], []

    class Kept(profiling.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    real_replace = os.replace

    def replace(src, dst):
        replaced.append((str(dst), os.path.getsize(src)))
        real_replace(src, dst)

    monkeypatch.setattr(seg, "StageTimer", Kept)
    monkeypatch.setattr(os, "replace", replace)
    paths = {k: str(out / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    status = {}
    t0 = time.monotonic()
    getSegmentation(slide, status=status, **paths, **KW)
    wall = time.monotonic() - t0
    (timer,) = timers
    return status, wall, timer, replaced, paths


@pytest.fixture(scope="module")
def call(synthetic_slide, tmp_path_factory):
    # a warm-up call first, as the benchmark's set-up makes one: the
    # native TIFF backend builds and the engine's modules import on first
    # use, outside any span
    with pytest.MonkeyPatch.context() as mp:
        out = tmp_path_factory.mktemp("traced")
        _segment(synthetic_slide[0], out, mp)
        return (out,) + _segment(synthetic_slide[0], out, mp)


def test_timings_hold_every_span(call):
    _, status, _, timer, _, _ = call
    t = status["timings"]
    assert set(NEW_SPANS) | {"plan", "infer", "flush", "finalize",
                             "write", "total"} <= set(t)
    assert t["counters"]["bytes_written"] > 0
    roles = {s.name: s.role for s in timer.spans}
    assert {roles[n] for n in ("flush", "flush.fetch", "flush.state",
                               "flush.accumulate")} == {"flusher"}
    assert {roles[n] for n in WEIGHTS + ("loader_wait", "flush_wait",
                                         "write.pyramid")} == {"main"}
    parent = {s.name: timer.spans[s.parent].name for s in timer.spans
              if s.parent is not None}
    assert parent["finalize.sync"] == "finalize"
    assert {parent[n] for n in ("write.quantize", "write.sync",
                                "write.pyramid")} == {"write"}
    assert {parent[n] for n in ("flush.fetch", "flush.state",
                                "flush.accumulate")} == {"flush"}


def test_bytes_written_are_the_files_the_call_wrote(call):
    out, status, _, _, replaced, paths = call
    mm = out / "cache" / "memmaps"
    size = {p.name.rsplit("-", 1)[-1]: p.stat().st_size
            for p in mm.iterdir()}
    state = [n for dst, n in replaced if dst.endswith("-stitch.json")]
    # three maps, the 8-bit scratch map twice (probabilities and
    # uncertainty), the mask's, three pyramids and every state write
    want = (size["mean.dat"] + size["var.dat"] + size["count.dat"]
            + 2 * size["u8.dat"] + size["maskbin.dat"]
            + sum(os.path.getsize(p) for p in paths.values()) + sum(state))
    assert len(state) >= 3
    assert status["timings"]["counters"]["bytes_written"] == want


def test_total_starts_after_the_weights(call):
    _, status, wall, timer, _, _ = call
    t = status["timings"]
    # each figure is rounded to the millisecond
    assert t["total"] <= wall - sum(t[n] for n in WEIGHTS) + 0.003
    after = sum(s.end - s.start for s in timer.spans
                if s.role == "main" and s.parent is None
                and s.name not in WEIGHTS)
    assert t["total"] >= after - 0.001


def test_main_spans_cover_the_call(call):
    _, _, wall, timer, _, _ = call
    top = [s for s in timer.spans if s.role == "main" and s.parent is None]
    assert sum(s.end - s.start for s in top) >= 0.9 * wall


def test_python_writer_times_each_downsample(synthetic_slide, tmp_path,
                                            monkeypatch):
    """On the pure-Python TIFF backend each level below a pyramid's base
    is a main-thread ``write.pyramid.downsample`` span inside
    ``write.pyramid``, counted on the integer path: three uint8 maps, none
    on the float path."""
    from digipathai_tpu_torch.io import backend
    from digipathai_tpu_torch.io.tiff_py import TiffReader

    monkeypatch.setattr(backend, "_FORCED", "0")
    status, _, timer, _, paths = _segment(synthetic_slide[0], tmp_path,
                                          monkeypatch)
    levels = set()
    for p in paths.values():
        with TiffReader(p) as r:
            levels.add(len(r.pages) - 1)
    (below,) = levels
    assert below >= 2
    spans = [s for s in timer.spans if s.name == "write.pyramid.downsample"]
    assert len(spans) == 3 * below
    assert {(s.role, timer.spans[s.parent].name) for s in spans} == {
        ("main", "write.pyramid")}
    counters = status["timings"]["counters"]
    assert counters["downsample_int_levels"] == 3 * below
    assert counters["downsample_float_levels"] == 0
    assert status["timings"]["write.pyramid.downsample"] > 0


def test_profile_dir_traces_the_whole_call_main_thread_only(
        synthetic_slide, tmp_path, monkeypatch):
    """Under ``DPAI_PROFILE_DIR`` (a CPU ``torch.profiler`` over the
    whole call) every main-thread span is a ``stage:`` range, from the
    weights to the last write, and no flusher span is."""
    monkeypatch.setenv("DPAI_PROFILE_DIR", str(tmp_path / "prof"))
    _, _, timer, _, _ = _segment(synthetic_slide[0], tmp_path, monkeypatch)
    events = json.loads((tmp_path / "prof" / "segmentation.json")
                        .read_text())["traceEvents"]
    marked = {e["name"][6:] for e in events
              if e.get("name", "").startswith("stage:")}
    main = {s.name for s in timer.spans if s.role == "main"}
    assert main == marked
    assert set(WEIGHTS) | {"plan", "write.pyramid"} <= marked
    assert not any(n.startswith("flush") and n != "flush_wait"
                   for n in marked)


def test_maybe_profile_leaves_a_running_profiler_alone(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("DPAI_PROFILE_DIR", str(tmp_path))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.maybe_profile("inner"):
            torch.ones(2).sum()
    assert not (tmp_path / "inner.json").exists()
    with profiling.maybe_profile("outer"):
        torch.ones(2).sum()
    assert (tmp_path / "outer.json").exists()


def test_eight_threads_lose_no_update():
    timer = profiling.StageTimer()
    n, width = 300, 8
    errors = []

    def work(k):
        try:
            for _ in range(n):
                with timer.stage(f"outer-{k}"):
                    with timer.stage(f"inner-{k}"):
                        timer.count("calls", 1)
                    timer.count("bytes", 3)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), name=f"pool_{k}")
                   for k in range(width)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert timer.counters == {"calls": n * width, "bytes": 3 * n * width}
    assert len(timer.spans) == 2 * n * width
    for s in timer.spans:
        assert s.role == "pool" and s.end >= s.start
        outer = s.name.startswith("outer")
        assert (s.parent is None) == outer
        if not outer:
            p = timer.spans[s.parent]
            assert p.name == "outer-" + s.name.split("-")[1]
            assert p.start <= s.start and s.end <= p.end
    summary = timer.summary()
    assert summary["counters"] == {"bytes": 3 * n * width,
                                   "calls": n * width}
    assert summary["outer-0"] >= summary["inner-0"] > 0


def _ctx(slides):
    from portbench.run import Ctx

    ctx = Ctx()
    ctx.slides = slides
    return ctx


#: two window slides of 4 s and 5 s
SLIDES = [
    {"wall": 4.0, "timings": {
        "build": 0.1, "load": 0.2, "to_device": 0.1, "loader_wait": 0.08,
        "flush_wait": 0.04, "write.pyramid": 1.6, "finalize.sync": 0.2,
        "write.sync": 0.12, "total": 3.5,
        "counters": {"bytes_written": 380_000_000}}},
    {"wall": 5.0, "timings": {
        "build": 0.2, "load": 0.3, "to_device": 0.1, "loader_wait": 0.2,
        "flush_wait": 0.1, "write.pyramid": 2.5, "finalize.sync": 0.3,
        "write.sync": 0.2, "total": 4.3,
        "counters": {"bytes_written": 390_000_000}}},
]


@pytest.mark.parametrize("metric,want", [
    ("reload_s", (0.4 + 0.6) / 2),
    ("loader_wait_share", (2.0 + 4.0) / 2),
    ("flush_wait_share", (1.0 + 2.0) / 2),
    ("pyramid_share", (40.0 + 50.0) / 2),
    ("sync_share", (8.0 + 10.0) / 2),
    ("written_mb", 385.0),
])
def test_metric_reader(metric, want):
    from portbench.run import metric_reader

    read = metric_reader(metric)
    assert read(_ctx(SLIDES)) == pytest.approx(want, rel=1e-12)
    # a program without these spans (the timings before them) reads None
    old = {"plan": 0.1, "infer": 1.0, "write": 2.0, "total": 3.5}
    assert read(_ctx([{"wall": 4.0, "timings": old}])) is None
