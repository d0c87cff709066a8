#!/usr/bin/env python3
"""Run one cell of the benchmark of ``digipathai_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks for.
``BENCHMARK.json`` names the cell; its configuration and traffic files,
and a reader per metric, are found here by name (``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``).

A run: set-up (the kernels' build where the checkout has none, the slides
and the weights from the seed, one warm-up slide of the cell's own
configuration and mode); the window, a closed loop of
``getSegmentation`` calls on one slide, from the first timed call to the
first slide that ends after ``--seconds``; with ``--trace 1`` one more
slide under ``torch.profiler``; then the program's state is freed and the
plain reference computes the slide's maps, against which a sample of the
window's slides, drawn from the seed, is judged (``judge.py``).  The last
line of standard output is one JSON object; the numbers judged, each
beside its limit, are the last lines of standard error.

``--control fp8`` puts the reference computed in float8 in the program's
place (its maps, and pyramids written by ``slides.write_tiled_pyramid``):
it reads the limits' upper ends for ``PERF.md``, never the benchmark's
runs.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "digipathai_tpu")
#: slides of the window, drawn from the seed, whose outputs are kept and
#: judged besides the last one
KEEP_AT_MOST = 1


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def file_bytes(*dirs) -> int:
    """The sizes of the files under ``dirs``: what a step that wrote them
    afresh wrote (the kernel's own write counters read 0 in the card's
    sandbox)."""
    return sum(p.stat().st_size for d in dirs if d.exists()
               for p in d.rglob("*") if p.is_file())


def cpu_seconds() -> float:
    """The process's CPU seconds, all threads: against a slide's wall it
    tells a host that ran the same work slower from one that waited."""
    t = os.times()
    return t.user + t.system


def tmpdir_fs() -> str:
    """The type of the file system ``TMPDIR`` lies on, where the program's
    memmaps and pyramids go."""
    path = os.path.realpath(tempfile.gettempdir())
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fs = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best[0]):
                best = (mnt, fs)
    return best[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(BENCHMARK.json, the workload's entry, its config file, its traffic
    file); the traffic file lies in ``traffic/`` beside ``run.py``, or
    beside ``bench_path`` where that has a ``traffic/`` of its own."""
    bench = load_json(bench_path)
    tdir = Path(bench_path).parent / "traffic"
    if not tdir.is_dir():
        tdir = HERE / "traffic"
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(tdir / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def engine_kwargs(config: dict, traffic: dict, device) -> dict:
    kw = {
        "patch_size": config["patch_size"],
        "stride_size": config["stride_size"],
        "batch_size": config["batch_size"],
        "tta_list": list(config["tta"]) or None,
        "quick": config["quick"],
        "model": config["models"][0],
        "mode": config["mode"],
        "threshold": config["threshold"],
        "compute_dtype": config["compute_dtype"],
        "data_parallel": False,
        "device": device,
    }
    kw.update(traffic["engine"])
    return kw


class Ctx:
    """What the metric readers read."""

    def __init__(self):
        self.slides = []
        self.window_s = self.setup_s = 0.0
        self.planned_patches = 0
        self.flops_per_slide = 0.0
        self.trace = None
        self.launches = {}
        self.expected_launches = {}

    def note(self, msg: str) -> None:
        """Say why a metric is left out of the result."""
        log(msg)

    def stage_share(self, names) -> float:
        walls = sum(s["wall"] for s in self.slides)
        spent = sum(b - a for s in self.slides for n, a, b in s["spans"]
                    if n in names)
        return 100.0 * spent / walls if walls else None


def read_launches() -> dict:
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    return {"fused_conv3x3": conv_fused.fused_conv3x3.launches,
            "fused_up_stage": stage_fused.fused_up_stage.launches}


def reference_modules(config: dict) -> dict:
    """{model: its reference module}: ``reference/<file>.py`` as the
    configuration's ``reference`` names it per model."""
    import importlib

    return {n: importlib.import_module(
        f"portbench.reference.{config['reference'][n]}")
        for n in config["models"]}


def tta_names(config: dict) -> list:
    return ["DEFAULT"] + [t for t in config["tta"] if t != "DEFAULT"]


def reference_maps(slide_path, groups, config, cache, device, precision):
    """The reference's (mean, var, count) maps of the slide in patch mode,
    computed on ``device`` in ``precision`` (``layers.PRECISIONS``), TF32
    off."""
    import torch

    from portbench import weights
    from portbench.reference import layers, maps, tiff

    mods = reference_modules(config)
    params = {n: weights.load(weights.path(cache, config["mode"], n), device)
              for n in config["models"]}
    models = maps.load_models(config["models"], params,
                              layers.PRECISIONS[precision], mods)
    img = tiff.read_level(str(slide_path), 0)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return maps.patch_maps(img, groups, models, tta_names(config),
                               config["patch_size"], device,
                               batch=config["batch_size"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def work_per_slide(config, groups, batches, mods):
    """(FLOPs the forwards need, {wrapper: [shape per launch]}) of one
    slide: planned patches x transforms x models at the patch; the conv
    kernel's launches per padded batch, transform and model."""
    from portbench import work

    n_tta = len(tta_names(config))
    side, n = config["patch_size"], config["batch_size"]
    patches = sum(len(g) for g in groups.values())
    flops = patches * n_tta * sum(work.model_flops(mods[m], side)
                                  for m in config["models"])
    convs = [s for m in config["models"] for s in work.unet_kernels(m, n,
                                                                     side)]
    return flops, {"fused_conv3x3": convs * (batches * n_tta)}


def finite(v: float) -> float:
    return v if math.isfinite(v) else sys.float_info.max


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        control: str = "", bench_path: Path = ROOT / "BENCHMARK.json",
        workdir: Path = None) -> dict:
    """One run of ``workload``; returns the result object."""
    bench, cell, config, traffic = load_cell(workload, bench_path)
    workdir = Path(workdir or Path(tempfile.gettempdir())
                   / f"portbench-{workload}")
    shutil.rmtree(workdir, ignore_errors=True)
    cache, out = workdir / "cache", workdir / "out"
    out.mkdir(parents=True)
    os.environ["DPAI_OFFLINE"] = "1"
    os.environ["DPAI_CACHE"] = str(cache)
    try:
        return _run(bench, cell, config, traffic, seed, seconds, trace,
                    device, control, workdir, cache, out)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(bench, cell, config, traffic, seed, seconds, trace, device,
         control, workdir, cache, out):
    import numpy as np
    import torch

    from portbench import judge, slides, spans, weights, work
    from portbench.reference import plan as ref_plan

    on_card = torch.device(device).type == "cuda"
    split = {}
    t = time.monotonic()
    from digipathai_tpu_torch.engine.segmentation import getSegmentation

    recorder = spans.Recorder()
    spans.install(recorder)
    split["import"] = time.monotonic() - T_START
    t = time.monotonic()
    if on_card:
        from digipathai_tpu_torch import _build
        from digipathai_tpu_torch.io import backend

        _build.build_all()
        backend.use_native()  # builds the native TIFF backend where it can
    split["build"] = time.monotonic() - t

    t = time.monotonic()
    slide = workdir / "slide.tiff"
    slides.write_tiled_pyramid(str(slide), slides.render(traffic["slide"],
                                                        seed))
    warm = slide  # a warm-up slide of the cell's own size is the slide
    if traffic["warmup"] != traffic["slide"]:
        warm = workdir / "warm.tiff"
        slides.write_tiled_pyramid(str(warm), slides.render(
            traffic["warmup"], seed))
    groups, _ = ref_plan.plan(str(slide), config["patch_size"],
                              config["stride_size"],
                              traffic["engine"].get("supertile", 4096))
    planned = sum(len(g) for g in groups.values())
    batches = sum(max(1, -(-len(g) // config["batch_size"]))
                  for g in groups.values())
    split["slides"] = time.monotonic() - t

    t = time.monotonic()
    mods = reference_modules(config)
    for i, name in enumerate(config["models"]):
        p = weights.make(mods[name].shapes().items,
                         weights.model_seed(seed, i), device)
        weights.save(p, weights.path(cache, config["mode"], name))
        del p
    split["weights"] = time.monotonic() - t

    kw = engine_kwargs(config, traffic, device)

    def call(path, i):
        """One ``getSegmentation``; returns (mask, pyramid paths, status,
        wall, bytes of the files it wrote: its memmaps, the 8-bit scratch
        map twice as it is rewritten for the second pyramid, and its three
        pyramids)."""
        status = {}
        paths = {k: str(out / f"{i}-{k}.tiff")
                 for k in ("probs", "mask", "uncertainty")}
        t0 = time.monotonic()
        mask = getSegmentation(str(path), probs_path=paths["probs"],
                               mask_path=paths["mask"],
                               uncertainty_path=paths["uncertainty"],
                               status=status, **kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        nbytes = sum(p.stat().st_size * (2 if p.name.endswith("-u8.dat")
                                         else 1)
                     for p in (cache / "memmaps").glob(f"{path.stem}-*"))
        nbytes += sum(os.path.getsize(p) for p in paths.values())
        return mask, paths, status, wall, nbytes

    t = time.monotonic()
    if control != "fp8":
        call(warm, "warm")
        recorder.take()
    # what set-up wrote (the slide, the weights, the warm-up's outputs) is
    # handed to storage now, not written back inside the window
    os.sync()
    split["warmup"] = time.monotonic() - t
    ctx = Ctx()
    ctx.setup_s = time.monotonic() - T_START
    ctx.planned_patches = planned
    log("setup split, s: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in split.items())
        + f"; setup_s {ctx.setup_s:.3f}; set-up wrote {file_bytes(workdir)}"
        " bytes of files")
    log(f"slide {traffic['slide']}: {planned} planned patches, "
        f"{len(groups)} tissue supertiles, {batches} batches")
    log(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} "
        f"usable, {torch.get_num_threads()} torch threads, TMPDIR on "
        f"{tmpdir_fs()}")

    keep_rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), 7]))
    kept, attempted, failed = [], 0, 0
    mdir = cache / "memmaps"
    kdir = workdir / "kept"
    kdir.mkdir()
    if control != "fp8":
        t_w0 = time.monotonic()
        while True:
            i = attempted
            attempted += 1
            cpu0 = cpu_seconds()
            try:
                mask, paths, status, wall, nbytes = call(slide, i)
            except Exception:  # noqa: BLE001 - counted, reported, judged
                failed += 1
                log(f"slide {i} failed:\n{traceback.format_exc()}")
                if failed > 3:
                    break
                continue
            ctx.slides.append({"wall": wall, "timings": status.get("timings"),
                               "spans": recorder.take(), "bytes": nbytes})
            log(f"slide {i}: {wall:.3f} s, wrote {nbytes} bytes, stages "
                f"{status.get('timings')}, process CPU "
                f"{cpu_seconds() - cpu0:.3f} s")
            closed = (time.monotonic() - t_w0 >= seconds
                      and len(ctx.slides) >= traffic["min_slides"])
            if closed or (len(kept) < KEEP_AT_MOST
                          and keep_rng.random() < 1 / 3):
                maps_ = {}
                for k in ("mean", "var", "count", "maskbin"):
                    (src,) = mdir.glob(f"slide-*-{k}.dat")
                    maps_[k] = kdir / f"{i}-{k}.dat"
                    os.replace(src, maps_[k])
                kept.append((i, mask, paths, maps_))
            else:
                for p in paths.values():
                    os.unlink(p)
            if closed:
                break
        ctx.window_s = time.monotonic() - t_w0
        log(f"window: {len(ctx.slides)} slides in {ctx.window_s:.3f} s, "
            f"{sum(s['bytes'] for s in ctx.slides)} bytes of files")

    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    ctx.flops_per_slide, launches = work_per_slide(config, groups, batches,
                                                   mods)

    breakdown = None
    if trace and control != "fp8":
        from portbench import trace as tr

        before = read_launches()
        (mask, paths, status, wall, _), ctx.trace = tr.profile(
            lambda: call(slide, "traced"))
        ctx.launches = {k: v - before[k] for k, v in read_launches().items()}
        ctx.expected_launches = launches
        ops = sorted(ctx.trace.kernel_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(ctx.trace.idle_gaps(), key=lambda g: -g[1])
        breakdown = {"device_ops": [[n[:160], s] for n, s in ops[:10]],
                     "idle_gaps": [[n, s] for n, s in gaps[:10]]}
        log(f"traced slide: wall {ctx.trace.wall:.3f} s, device busy "
            f"{ctx.trace.busy_s():.3f} s, launches {ctx.launches}, "
            f"expected {({k: len(v) for k, v in launches.items()})}")

    # the program's state is freed before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.monotonic()
    ref_mean, ref_var, ref_count = reference_maps(slide, groups, config,
                                                  cache, device, "f32")
    ref = {"mean": ref_mean, "var": ref_var, "count": ref_count}
    log(f"reference: {time.monotonic() - t:.3f} s")
    limits = traffic["limits"]
    numbers = []
    if control == "fp8":
        attempted = 1
        m, v, c = reference_maps(slide, groups, config, cache, device,
                                 "fp8")
        paths = {}
        for k, img in (("probs", judge._u8(m)), ("uncertainty", judge._u8(v)),
                       ("mask", np.where(m >= config["threshold"], 255, 0))):
            paths[k] = str(out / f"control-{k}.tiff")
            slides.write_tiled_pyramid(paths[k], img.astype(np.uint8),
                                       quality=90)
        mask = np.where(m >= config["threshold"], 255, 0).astype(np.uint8).T
        numbers.append(judge.judge({"mean": m, "var": v, "count": c,
                                    "mask": mask, "tiffs": paths}, ref,
                                   limits, config["threshold"]))
    Y, X = ref_mean.shape
    for i, mask, paths, maps_ in kept:
        prog = {k: np.memmap(maps_[k], np.float32, "r", shape=(Y, X))
                for k in ("mean", "var", "count")}
        prog.update(mask=mask, tiffs=paths)
        numbers.append(judge.judge(prog, ref, limits, config["threshold"]))
        log(f"slide {i}: " + ", ".join(f"{k} {v}"
                                       for k, v in numbers[-1].items()))
    correct, checks = judge.verdict(numbers, limits)
    correct = correct and failed == 0

    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace) if ctx.slides else ():
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.wall
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default="")
    args = ap.parse_args(argv)
    _, cell, _, _ = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        log(f"needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda:0", control=args.control)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"the process loaded {loaded}: no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
