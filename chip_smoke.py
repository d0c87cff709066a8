#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (digipathai_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - card name and power limit (nvidia-smi), torch/CUDA versions;
2. build   - compile every CUDA kernel from csrc/, one nvcc per source, all
             started together; each build's seconds and ptxas registers
             and spills;
3. kernels - each kernel against its plain PyTorch version at the main
             paths' shapes, with timings: fused_conv3x3 at every distinct
             conv shape of the dense and Inception batch-32 forwards and
             of the dense tile forward in bf16 (kernel-only time from
             back-to-back launches in one CUDA graph with operands prepared
             beforehand, the wrapper's time, the plain version, cuDNN's
             conv alone, the bound, the plan; launch-weighted totals over
             the dense forwards and over dense and Inception), then f32
             (TF32 off) and ragged checks; fused_up_stage at the decoder
             stages of the dense and Inception 4352^2 tile forwards in
             bf16 (kernel-only, wrapper, plain, bound, plans) and two
             ragged stages in bf16 and f32; bilateral_message at the CRF's
             1024^2 and 1024x512 grids and do_crf's 256^2 r=20 grid
             (kernel-only and wrapper times, plain, bound, plan), then
             ragged, tiny, r=0, sentinel-padded, L=3, L=5 and large-radius
             checks;
4. model   - a full DenseNet121-U-Net forward, batch 32 at 256^2 in bf16,
             through the kernel and through the plain version, and one
             torch.profiler pass over it (device busy share, the conv
             kernel's summed time); weights loaded into that model after
             its forwards give a fresh model's output bit for bit; one
             tile-mode forward at (1, 4352, 4352, 3) with fused_stages=5
             (58 conv and 5 stage launches), through fused_up_stage and
             through its plain version; Inception and DeepLab in f32 on
             the card against the CPU on a small input; the
             Inception-ResNet-v2-U-Net at batch 32 (10 conv launches) and
             at 4352^2 with fused_stages=5 (5 stage launches, no conv),
             through the kernels and their plain versions; DeepLabv3+ at
             batch 32 and at 4352^2 with aspp_pool_window=256; one
             torch.profiler pass over the batch-32 ensemble forward (device
             busy share, each model's share of the device time);
4a. weights - each model's seeded weights written as a trained checkpoint
             with the port's own writers (the .h5 when h5py imports, else
             the converted .npz cache), loaded by load_variables onto the
             card from the .h5 and then from the cache, bit for bit;
4b. fold   - fold_bn on each model at batch 32 in bf16 and f32, folded
             against unfolded;
4c. quant  - dense (quantized=True) and DeepLab ("static", calibrated on
             the card): f32 card vs CPU (the CPU's int8 convs fed the
             card's inputs), every int8 conv replayed exactly
             on the CPU, and at batch 32 and at the 4352^2 tile the
             quantized forward beside the exact one (max|dp|, ms, launches,
             int8 convs per route);
5. engine  - getSegmentation (dense, quick) on a synthetic slide, in patch
             mode and in tile mode with fused_stages=5, each without and
             with crf=True: three readable TIFFs, a mask of shape (X, Y), 68
             conv launches per batch in patch mode, 58 conv and 5 stage
             launches per supertile forward in tile mode and, with the CRF,
             n_iters bilateral launches per tissue supertile, and one
             torch.profiler pass over the CRF's work on one supertile
             (bilateral, blurs, copies, other kernels, host steps); then
             the 3-model ensemble (quick=False) in patch mode (68 + 10 conv
             launches per batch) and in tile mode with fused_stages=5
             without and with crf=True (58 conv and 5 + 5 stage launches
             per supertile), each with its wall and stages; then the
             ensemble in tile mode with quantized="deeplabv3:static",
             dense with fold_bn=True in patch mode and dense from the
             checkpoint 4a wrote, each with its wall, stages and launches;
             then the oracle model against the slide's known lesion (patch
             mode
             without and with the CRF, and tile mode); then the oracle CRF
             run on the card against the CPU;
6. server  - the WSGI app in process: GET /, the .dzi, POST /segment with
             crf=1, then with inference_mode=tile&crf=1 on an engine with
             fused_stages=5, then with quick=0 (the ensemble), each polled
             to Done, then the mask's .dzi and one mask tile.

Each main path runs with every launch count set to 0 just before it and
read just after.  Prints a JSON line of per-kernel results, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

PATCH = 256
BATCH = 32
SLIDE = (6144, 4096)  # (X, Y): two 4096 supertiles, dozens of batches
# bf16 forward, kernel vs plain: per-conv differences of about one bf16
# rounding, carried through 121 layers.  Measured on an H100: max|dp| 4.1e-3.
MODEL_BOUND = 0.02
# f32 forward, card (TF32 off) vs CPU: the bound of the CPU parity tests
F32_MODEL_BOUND = 1e-4
# bf16 bound of kernel vs plain: the plain version rounds the conv output to
# bf16 before its affine (2^-8 relative) and rounds again after it; the
# kernel rounds once.  Two roundings of 2^-8 of the output scale, doubled.
BF16_REL = 2.0 ** -6
# f32 bound (TF32 off on both sides): only the summation order differs.
F32_REL = 2e-4
# fused_conv3x3 rows checked in f32 (TF32 off) as well, and the ragged
# (scalar-path) shape: (name, N, H, W, C, F, pre-affine)
CONV_F32_SHAPES = [
    ("dense_layer", 32, 64, 64, 128, 32, True),
    ("decoder_widest", 32, 16, 16, 1344, 320, False),
    ("decoder_largest", 32, 256, 256, 96, 64, False),
    ("ragged", 3, 13, 29, 5, 7, True),
]
# the tile forward: supertile 4096 + a 128 px halo, one 4352^2 forward
TILE_SIDE = 4096 + 2 * 128
STAGE_RAGGED = [  # the scalar load path, the SAME borders, no relu:
    # (name, N, Hh, Wh, C, Cs, F, relu)
    ("ragged", 1, 13, 29, 5, 3, 7, True),
    ("ragged_noskip", 1, 8, 12, 5, 0, 7, False),
]
# bilateral message, kernel vs plain (tests/test_pallas.py's bound): only
# the summation order and exp's rounding differ
BIL_BOUND = 2e-5
BIL_CASES = [  # (name, H, W, L, r, sigma_xy, sigma_rgb, sentinel)
    # the engine's grids: 4096^2 and 4096x2048 buckets downsampled 4x
    ("crf_4096", 1024, 1024, 2, 10, 12.5, 20.0, False),
    ("crf_4096x2048", 1024, 512, 2, 10, 12.5, 20.0, False),
    # do_crf's colour term: a 1024^2 label map downsampled 4x, r=20, L=3
    ("do_crf", 256, 256, 3, 20, 20.0, 13.0, False),
    ("ragged", 70, 90, 2, 10, 12.5, 20.0, False),
    ("ragged_tall", 333, 130, 2, 10, 12.5, 20.0, False),
    ("small", 48, 48, 2, 3, 12.5, 20.0, False),
    ("r5", 320, 480, 2, 5, 12.5, 20.0, False),
    ("r20", 256, 600, 2, 20, 12.5, 20.0, False),
    ("r0", 40, 50, 2, 0, 12.5, 20.0, False),
    ("below_window", 5, 7, 2, 10, 12.5, 20.0, False),
    ("one_row", 1, 300, 2, 10, 12.5, 20.0, False),
    ("one_column", 300, 1, 2, 10, 12.5, 20.0, False),
    ("sentinel", 256, 200, 2, 10, 12.5, 20.0, True),
    ("labels3", 100, 120, 3, 10, 12.5, 20.0, False),
    ("labels5", 60, 70, 5, 10, 12.5, 20.0, False),
    # radii the kernel takes at run time, at K = 2 and at K = 1
    ("r30", 64, 80, 1, 30, 12.5, 20.0, False),
    ("r50", 40, 120, 1, 50, 12.5, 20.0, False),
]
# rows whose plain version is timed too (the others are only checked)
BIL_TIMED = ("crf_4096", "crf_4096x2048", "do_crf")
# the oracle CRF run, card vs CPU, f32: the bilateral kernel and the plain
# message differ by ~1e-6 per iteration, cuDNN and the CPU conv likewise
CRF_DEVICE_BOUND = 1e-4
# fold_bn, folded vs unfolded forward: bf16 (a rounding moved per conv, as
# MODEL_BOUND) and f32 (tests/test_fold_bn.py's bound)
FOLD_BF16 = 0.02
FOLD_F32 = 2e-4
# int8 forward in f32, card vs CPU, with every int8 conv of the CPU's
# forward fed the card's input at that layer: a value a rounding error away
# from a .5 step quantizes either way and the flip would propagate (JAX's
# own quantized forward moves p by up to 4.5e-3 under a 1e-7 relative
# input change, tests/test_torch_quant.py).  Bound on p, and on the CPU's
# own input at each int8 conv against the card's, over its scale
QUANT_F32 = 1e-4
# one int8 conv, card vs the CPU's exact f64 sums on the same integers: the
# products are exact, the f32 sums on the card round above 2^24
INT8_REL = 1e-5
# peaks of one H100 SXM (NVIDIA's data sheet, dense): bytes/s and FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def log(msg):
    print(msg, flush=True)


def make_synthetic_slide(path, width, height, seed=0):
    """The synthetic slide of ``tests/fixtures.py::make_synthetic_slide``:
    ``render_he_like`` (pure numpy, loaded by path: another installed
    package may own the top-level name ``tests``) written with the port's
    own pyramid writer."""
    import importlib.util

    from digipathai_tpu_torch.io.backend import write_pyramid

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures.py")
    spec = importlib.util.spec_from_file_location("dpai_fixtures", fixtures)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    img, tissue, lesion = mod.render_he_like(width, height, seed)
    write_pyramid(path, img, compression="jpeg", quality=92, mpp=0.5,
                  description="DigiPathAI-TPU synthetic fixture")
    return {"width": width, "height": height, "tissue_mask": tissue,
            "lesion_mask": lesion}


def bound(flop, nbytes, kind):
    """(ms, what bounds it): the least time the card could take."""
    t_ops, t_bytes = flop / PEAK_FLOPS[kind], nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=2) -> float:
    """Median device time of ``fn`` in ms (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phase_device(state):
    import torch

    state["smi"] = smi_line()
    log(f"[device] {state['smi']} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    state["tmp"] = tempfile.mkdtemp(prefix="dpai_chip_smoke_")
    os.environ["DPAI_CACHE"] = os.path.join(state["tmp"], "cache")
    os.environ["DPAI_OFFLINE"] = "1"


def phase_build(state):
    from digipathai_tpu_torch import _build

    t = time.time()
    paths = _build.build_all()
    for name, path in paths.items():
        _build.load(name)
        log(f"[build] {name}.cu -> {path.name} "
            f"({_build.build_seconds.get(name, 0.0):.1f} s)")
        for line in _build.build_logs.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "Function pr")):
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(paths)} kernels in {time.time() - t:.2f} s")


def graph_ms(fn, count=20, reps=3) -> float:
    """Kernel-only time of ``fn`` in ms: ``count`` back-to-back calls
    captured in one CUDA graph (no host work between them), the graph
    replayed ``reps`` times between one pair of CUDA events, divided by
    the number of calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (reps * count)


def conv_inputs(n, h, w, c, f, pre, dtype, seed):
    """x, the HWIO kernel and the affine or pre-affine of one conv, drawn
    on the card (the tile forward's dense layers read 151M values)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def uni(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    x = rnd(n, h, w, c).to(dtype)
    k = rnd(3, 3, c, f) / (9 * c) ** 0.5
    if pre:  # pre_add > 0: the halo-leak case
        kw = {"pre_mul": uni(c) + 0.5, "pre_add": uni(c) * 0.4 + 0.1,
              "relu": False}
    else:
        kw = {"bias": rnd(f) * 0.1, "mul": uni(f) + 0.5,
              "add": rnd(f) * 0.1}
    return x, k, kw


def check(name, got, ref, rel):
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not torch.isfinite(got).all() or not err <= rel * scale:
        raise AssertionError(f"{name}: max|d| {err} > {rel * scale} or "
                             f"non-finite")
    return err, rel * scale


def plan_text(plan) -> str:
    if not plan.vector:
        return "scalar"
    return (f"wgmma bn={plan.bn} bk={plan.bk} tile={plan.th}x{plan.tw} "
            f"split={plan.splits} stages={plan.stages}")


def main_path_convs():
    """(name, (n, h, w, c, f, pre), {model: launches per forward}) of every
    distinct conv of the dense and Inception batch-32 forwards and of their
    tile forwards (with fused_stages=5, Inception's tile forward launches
    no conv)."""
    from digipathai_tpu_torch.models import densenet_unet, inception_unet

    rows = {}
    for model, mod in (("dense", densenet_unet),
                       ("inception", inception_unet)):
        for tag, calls in (("patch", mod.kernel_calls(BATCH, PATCH)),
                           ("tile", mod.kernel_calls(1, TILE_SIDE, 5))):
            for kind, shape, count in calls:
                if kind == "conv":
                    n, h, w, c, f, pre = shape
                    what = "dense" if pre else "decoder"
                    name = f"{tag} {what} ({n},{h},{w},{c})->{f}"
                    rows.setdefault((name, shape), {})[model] = count
    return [(name, shape, counts) for (name, shape), counts in rows.items()]


def main_path_stages():
    """(name, (n, hh, wh, c, cs, f), {model: launches per forward}) of every
    distinct stage of the dense and Inception tile forwards with
    fused_stages=5."""
    from digipathai_tpu_torch.models import densenet_unet, inception_unet

    rows = {}
    for model, mod in (("dense", densenet_unet),
                       ("inception", inception_unet)):
        stages = [s for k, s, _ in mod.kernel_calls(1, TILE_SIDE, 5)
                  if k == "stage"]
        for i, shape in enumerate(stages):
            key = rows.setdefault(shape, [f"{model} stage{i + 1}", {}])
            key[1][model] = 1
    return [(name, shape, counts) for shape, (name, counts) in rows.items()]


def launches_text(counts) -> str:
    return ", ".join(f"{m} x{c}" for m, c in counts.items())


def phase_kernels(state):
    # the f32 conv and stage rows compare against cuDNN and cuBLAS in full
    # f32; the switches go back to the user's settings for the phases that
    # follow
    prev = no_tf32()
    try:
        kernels_conv(state)
        kernels_stage(state)
    finally:
        restore_tf32(prev)
    kernels_bilateral(state)


def kernels_conv(state):
    """fused_conv3x3 at every distinct main-path shape in bf16 (kernel-only,
    wrapper, plain and cuDNN times, bound, plan), then the f32 and ragged
    checks."""
    import torch
    import torch.nn.functional as F

    from digipathai_tpu_torch.ops import conv_fused as cf

    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0}
    tot_dense = dict(tot)
    worst, bound_by = 0.0, {}
    for name, (n, h, w, c, f, pre), counts in main_path_convs():
        count = sum(counts.values())
        x, k, kw = conv_inputs(n, h, w, c, f, pre, torch.bfloat16, seed=c + f)
        relu = kw.pop("relu", True)
        ops = cf.prepare(k, **kw, dtype=x.dtype, device=x.device)
        plan = cf.plan_conv(n, h, w, c, 0, f, x.dtype)
        got = cf.fused_conv3x3(x, ops, relu=relu)
        ref = cf.fused_conv3x3_plain(x, k, **kw, relu=relu)
        err, lim = check(f"fused_conv3x3 {name}", got, ref, BF16_REL)
        worst = max(worst, err)
        out = torch.empty_like(got)
        part = cf.scratch([plan], n * h * w, f, x.device)
        t_k = graph_ms(lambda: cf.launch(x, ops, relu=relu, out=out,
                                         part=part, plan=plan))
        t_w = time_ms(lambda: cf.fused_conv3x3(x, ops, relu=relu))
        t_p = time_ms(lambda: cf.fused_conv3x3_plain(x, k, **kw, relu=relu))
        # the library yardstick: cuDNN's conv alone (no affine, no
        # pre-activation), channels-last bf16 on the same inputs
        xc = x.permute(0, 3, 1, 2)
        kc = k.to(x.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t_l = graph_ms(lambda: F.conv2d(xc, kc, padding=1))
        flop = 2.0 * n * h * w * 9 * c * f
        b_ms, b_by = bound(flop, 2 * (x.numel() + k.numel() + n * h * w * f),
                           "bf16")
        log(f"[kernels] fused_conv3x3 {name} bf16 "
            f"({launches_text(counts)} per forward): "
            f"max|d|={err:.3e} (bound {lim:.3e}); kernel {t_k:.4f} ms "
            f"({flop / t_k / 1e9:.1f} TFLOP/s), wrapper {t_w:.4f} ms, plain "
            f"{t_p:.4f} ms, cuDNN alone {t_l:.4f} ms (kernel/cuDNN "
            f"{t_k / t_l:.2f}), bound {b_ms:.4f} ms ({b_by}); "
            f"{plan_text(plan)} | {state['smi']}")
        for key, v in (("ms", t_k), ("wrapper_ms", t_w), ("plain_ms", t_p),
                       ("bound_ms", b_ms), ("library_ms", t_l)):
            tot[key] += count * v
            tot_dense[key] += counts.get("dense", 0) * v
        bound_by[b_by] = bound_by.get(b_by, 0.0) + count * b_ms
        del x, k, kw, ops, got, ref, out, part, xc, kc
        torch.cuda.empty_cache()
    for name, n, h, w, c, f, pre in CONV_F32_SHAPES:
        dtypes = ((torch.float32, F32_REL),)
        if name == "ragged":
            dtypes += ((torch.bfloat16, BF16_REL),)
        for dtype, rel in dtypes:
            x, k, kw = conv_inputs(n, h, w, c, f, pre, dtype, seed=c + f)
            got = cf.fused_conv3x3(x, k, **kw)
            ref = cf.fused_conv3x3_plain(x, k, **kw)
            err, lim = check(f"fused_conv3x3 {name} {dtype}", got, ref, rel)
            t_w = time_ms(lambda: cf.fused_conv3x3(x, k, **kw))
            t_p = time_ms(lambda: cf.fused_conv3x3_plain(x, k, **kw))
            plan = cf.plan_conv(n, h, w, c, 0, f, dtype)
            timed = ""
            if name == "ragged":
                # kernel-only and cuDNN alone, as the main-path rows
                kw2 = dict(kw)
                relu = kw2.pop("relu", True)
                ops = cf.prepare(k, **kw2, dtype=dtype, device=x.device)
                out = torch.empty_like(got)
                t_k = graph_ms(lambda: cf.launch(x, ops, relu=relu, out=out,
                                                 plan=plan))
                xc = x.permute(0, 3, 1, 2)
                kc = k.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                t_l = graph_ms(lambda: F.conv2d(xc, kc, padding=1))
                b_ms, b_by = bound(
                    2.0 * n * h * w * 9 * c * f,
                    dtype.itemsize * (x.numel() + k.numel() + n * h * w * f),
                    "bf16" if dtype == torch.bfloat16 else "f32")
                timed = (f"kernel {t_k:.4f} ms, cuDNN alone {t_l:.4f} ms, "
                         f"bound {b_ms:.6f} ms ({b_by}), ")
                del ops, out, xc, kc
            log(f"[kernels] fused_conv3x3 {name} ({n},{h},{w},{c})->{f} "
                f"{str(dtype).split('.')[-1]}: max|d|={err:.3e} (bound "
                f"{lim:.3e}); {timed}wrapper {t_w:.3f} ms, plain {t_p:.3f} "
                f"ms; {plan_text(plan)} | {state['smi']}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            del x, k, kw, got, ref
    torch.cuda.empty_cache()
    for what, t in (("dense batch-32 forward + tile forward (68 + 58 "
                     "launches)", tot_dense),
                    ("dense and Inception batch-32 and tile forwards (68 + "
                     "58 + 10 + 0 launches)", tot)):
        log(f"[kernels] fused_conv3x3 over the {what}, launch-weighted: "
            f"kernel {t['ms']:.3f} ms, wrapper {t['wrapper_ms']:.3f} ms, "
            f"plain {t['plain_ms']:.3f} ms, cuDNN alone "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"| {state['smi']}")
    state["conv"] = {"max_abs_err": worst, **tot,
                     "bound_by": max(bound_by, key=bound_by.get),
                     "ms_covers": "the 68 launches of one dense batch-32 "
                                  "forward, the 58 of one dense tile "
                                  "forward and the 10 of one Inception "
                                  "batch-32 forward, each shape's time "
                                  "times its launches; ms kernel-only (CUDA "
                                  "graph), wrapper_ms per call with "
                                  "operands prepared beforehand; launches: "
                                  "the ensemble's patch run"}


def stage_inputs(n, hh, wh, c, cs, f, dtype, seed):
    """The arguments of fused_up_stage, drawn on the card (stage 5's y alone
    is 454M values): activations N(0, 1), kernels scaled to keep the
    pre-activations near unit variance, BN-like affines."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def pos(*shape):
        return torch.rand(*shape, generator=g, device="cuda") + 0.5

    y = rnd(n, hh, wh, c).to(dtype)
    ka = rnd(3, 3, c, f, scale=(9 * c) ** -0.5)
    kb = rnd(3, 3, f + cs, f, scale=(9 * (f + cs)) ** -0.5)
    skip = rnd(n, 2 * hh, 2 * wh, cs).to(dtype) if cs else None
    return (y, ka, rnd(f, scale=0.1), pos(f), rnd(f, scale=0.1), kb,
            rnd(f, scale=0.1), pos(f), rnd(f, scale=0.1), skip)


def stage_work(n, hh, wh, c, cs, f, itemsize):
    """(FLOP, bytes) one decoder stage needs: convA at the 4 taps that a
    nearest 2x upsample leaves distinct per output pixel (its 3x3 window
    covers 2 rows and 2 columns of y), convB at 9; y, skip, the output and
    both kernels read or written once."""
    m = 4 * n * hh * wh  # output pixels
    flop = 2.0 * m * f * (4 * c + 9 * (f + cs))
    nbytes = itemsize * (n * hh * wh * c + m * cs + m * f + 9 * c * f
                         + 9 * (f + cs) * f)
    return flop, float(nbytes)


def kernels_stage(state):
    """fused_up_stage at the five stages of a tile forward in bf16
    (kernel-only, wrapper and plain times, bound, plans), then the ragged
    rows in bf16 and f32."""
    import torch

    from digipathai_tpu_torch.ops import stage_fused as sf

    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    tot_dense = dict(tot)
    worst, bound_by = 0.0, {}
    rows = [(name, *shape, True, torch.bfloat16, counts)
            for name, shape, counts in main_path_stages()]
    rows += [(*r, dt, {}) for r in STAGE_RAGGED
             for dt in (torch.bfloat16, torch.float32)]
    for name, n, hh, wh, c, cs, f, relu, dtype, counts in rows:
        args = stage_inputs(n, hh, wh, c, cs, f, dtype, seed=c + cs + f)
        y, skip = args[0], args[-1]
        opa, opb = sf.prepare_stage(*args[1:9], dtype=dtype, device=y.device)
        plans = sf.stage_plans(n, hh, wh, c, cs, f, dtype)
        got = sf.fused_up_stage(y, opa, None, None, None, opb, None, None,
                                None, skip, relu=relu)
        ref = sf.fused_up_stage_plain(*args, relu=relu)
        rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
        err, lim = check(f"fused_up_stage {name} {dtype}", got, ref, rel)
        out, a = torch.empty_like(got), torch.empty_like(got)
        part = sf.scratch(plans, n * 4 * hh * wh, f, y.device)
        t_k = graph_ms(lambda: sf.launch(y, opa, opb, skip, relu=relu,
                                         out=out, a=a, part=part,
                                         plans=plans), count=5, reps=2)
        t_w = time_ms(lambda: sf.fused_up_stage(*args, relu=relu), reps=5)
        t_p = time_ms(lambda: sf.fused_up_stage_plain(*args, relu=relu),
                      reps=5)
        flop, nbytes = stage_work(n, hh, wh, c, cs, f, dtype.itemsize)
        b_ms, b_by = bound(flop, nbytes, "bf16" if dtype == torch.bfloat16
                           else "f32")
        log(f"[kernels] fused_up_stage {name} y ({n},{hh},{wh},{c}) skip "
            f"Cs={cs} -> F={f} {str(dtype).split('.')[-1]} "
            f"({launches_text(counts) or 'off the main paths'} per tile "
            f"forward): max|d|={err:.3e} "
            f"(bound {lim:.3e}); kernel {t_k:.3f} ms "
            f"({flop / t_k / 1e9:.1f} TFLOP/s), wrapper {t_w:.3f} ms, plain "
            f"{t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {flop / 1e9:.1f} "
            f"GFLOP, {nbytes / 1e9:.3f} GB); convA {plan_text(plans[0])}; "
            f"convB {plan_text(plans[1])} | {state['smi']}")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        count = sum(counts.values())
        for key, v in (("ms", t_k), ("wrapper_ms", t_w),
                       ("plain_ms", t_p), ("bound_ms", b_ms)):
            tot[key] += count * v
            tot_dense[key] += counts.get("dense", 0) * v
        if count:
            bound_by[b_by] = bound_by.get(b_by, 0.0) + count * b_ms
        del args, y, skip, opa, opb, got, ref, out, a, part
        torch.cuda.empty_cache()
    for what, t in (("five stages of one dense tile forward", tot_dense),
                    ("ten stages of one dense and one Inception tile "
                     "forward", tot)):
        log(f"[kernels] fused_up_stage, the {what}: kernel {t['ms']:.3f} "
            f"ms, wrapper {t['wrapper_ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"| {state['smi']}")
    # no single PyTorch call computes a whole decoder stage: library_ms null
    state["stage"] = {"max_abs_err": worst, **tot,
                      "bound_by": max(bound_by, key=bound_by.get),
                      "library_ms": None,
                      "ms_covers": "the five launches of one dense tile "
                                   "forward and the five of one Inception "
                                   "tile forward; ms kernel-only (CUDA "
                                   "graph), wrapper_ms per call on the raw "
                                   "parameters (operands prepared in the "
                                   "call); launches: the ensemble's tile "
                                   "run"}


def bilateral_work(h, w, n_labels, r):
    """(FLOP, bytes) the message needs: each in-image (pixel, neighbour)
    pair costs 3 subtractions, 5 operations for the squared colour
    distance, 2 for the exponent, the exponential, 1 for the denominator
    and 2 per label; q and the image are read once, the output written
    once."""
    ry, rx = min(r, h - 1), min(r, w - 1)
    sy = sum(h - abs(d) for d in range(-ry, ry + 1))
    sx = sum(w - abs(d) for d in range(-rx, rx + 1))
    pairs = sy * sx - h * w
    return pairs * (12 + 2 * n_labels), 4 * h * w * (2 * n_labels + 3)


def kernels_bilateral(state):
    """bilateral_message at every BIL_CASES shape against its plain version;
    kernel-only (CUDA graph) and wrapper times, the plan, and the bound."""
    import torch

    from digipathai_tpu_torch.ops.bilateral import (bilateral_message,
                                                    plan_bilateral)
    from digipathai_tpu_torch.ops.crf import _PAD_COLOR, _bilateral_message

    worst = 0.0
    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = {}
    for name, h, w, n_labels, r, sxy, srgb, sentinel in BIL_CASES:
        g = torch.Generator().manual_seed(h * w + r)
        img = torch.rand(h, w, 3, generator=g) * 255
        q = torch.rand(h, w, n_labels, generator=g)
        if sentinel:
            # a bucket-padded grid: pad rows carry the sentinel, a column
            # band its cell-mean dilution, and q is 0 in the pad
            img[h * 3 // 4:] = _PAD_COLOR
            img[:, w * 3 // 4:] = _PAD_COLOR / 16
            q[h * 3 // 4:] = 0.0
        img, q = img.cuda(), q.cuda()

        def call():
            return bilateral_message(q, img, sxy, srgb, r)

        got = call()
        ref = _bilateral_message(q, img, sxy, srgb, r)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or not err <= BIL_BOUND:
            raise AssertionError(f"bilateral_message {name}: max|d| {err} "
                                 f"(bound {BIL_BOUND}) or non-finite")
        worst = max(worst, err)
        plan = plan_bilateral(h, w, n_labels, r)
        what = (f"[kernels] bilateral {name} ({h},{w},{n_labels}) r={r}: "
                f"max|d|={err:.3e} (bound {BIL_BOUND}); plan K={plan.k} "
                f"warps={plan.warps} unrolled r={plan.spec} smem "
                f"{plan.smem} B, {plan.blocks} blocks")
        if name not in BIL_TIMED:
            log(what)
            del img, q, got, ref
            continue
        t_k = graph_ms(call)
        t_w = time_ms(call)
        t_p = time_ms(lambda: _bilateral_message(q, img, sxy, srgb, r),
                      reps=3, warmup=1)
        flop, nbytes = bilateral_work(h, w, n_labels, r)
        b_ms, b_by = bound(flop, nbytes, "f32")
        log(f"{what}; kernel {t_k:.4f} ms, wrapper {t_w:.4f} ms, plain "
            f"{t_p:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {flop / 1e9:.2f} "
            f"GFLOP; kernel/bound {t_k / b_ms:.2f}) | {state['smi']}")
        if name.startswith("crf_"):
            for key, v in (("ms", t_k), ("wrapper_ms", t_w),
                           ("plain_ms", t_p), ("bound_ms", b_ms)):
                tot[key] += v
            bound_by[b_by] = bound_by.get(b_by, 0.0) + b_ms
        del img, q, got, ref
    torch.cuda.empty_cache()
    # no single PyTorch call computes this message: library_ms is null
    state["bilateral"] = {"max_abs_err": worst, **tot,
                          "bound_by": max(bound_by, key=bound_by.get),
                          "library_ms": None,
                          "ms_covers": "one launch at each crf_ shape "
                                       "summed; ms kernel-only (20 launches "
                                       "in one CUDA graph), wrapper_ms one "
                                       "call with its host work; launches: "
                                       "the ensemble's tile run with "
                                       "crf=True"}


def phase_model(state):
    import torch

    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops import conv_fused
    from digipathai_tpu_torch.ops.color import normalize_patches

    m = build_model("dense", dtype=torch.bfloat16).init(PATCH, seed=0).cuda()
    g = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (BATCH, PATCH, PATCH, 3), generator=g,
                       dtype=torch.uint8).cuda()
    with torch.inference_mode():
        x = normalize_patches(u8)
        n0 = conv_fused.fused_conv3x3.launches
        p = m(x)
        torch.cuda.synchronize()
        n = conv_fused.fused_conv3x3.launches - n0
        with mock.patch.object(conv_fused, "fused_conv3x3",
                               conv_fused.fused_conv3x3_plain):
            q = m(x)
            t_p = time_ms(lambda: m(x), reps=5)
        t_k = time_ms(lambda: m(x), reps=5)
    if n != 68:
        raise AssertionError(f"forward launched the kernel {n} times, not 68")
    if tuple(p.shape) != (BATCH, PATCH, PATCH, 2) or not torch.isfinite(p).all():
        raise AssertionError(f"bad forward output {tuple(p.shape)}")
    d = (p[..., 1] - q[..., 1]).abs()
    log(f"[model] DenseNet121-U-Net bf16 ({BATCH},{PATCH},{PATCH},3): "
        f"{n} kernel launches; kernel vs plain max|dp|={d.max().item():.4e} "
        f"mean|dp|={d.mean().item():.4e} (bound {MODEL_BOUND}); forward "
        f"{t_k:.2f} ms through the kernel, {t_p:.2f} ms plain "
        f"({BATCH * 1000 / t_k:.1f} vs {BATCH * 1000 / t_p:.1f} patches/s) "
        f"| {state['smi']}")
    if d.max().item() > MODEL_BOUND:
        raise AssertionError(f"model max|dp| {d.max().item()} > {MODEL_BOUND}")
    profile_forward(state, m, x)
    reload_check(m, x, p)
    del p, q, d
    torch.cuda.empty_cache()
    tile_forward(state)
    small_input_check(state)
    models = {"dense": m,
              "inception": inception_forwards(state, x),
              "deeplabv3": deeplab_forwards(state, x)}
    profile_ensemble(state, models, x)
    del m, models, u8, x
    torch.cuda.empty_cache()


def reload_check(m, x, before):
    """Weights loaded after a forward take effect on the card: load another
    seed's weights, with BN statistics away from identity, into ``m`` (whose
    prepared operands are cached) and hold its output bit for bit against a
    model built with those weights."""
    import torch

    from digipathai_tpu_torch.models.registry import build_model

    fresh = randomize_bn(build_model("dense", dtype=torch.bfloat16).init(
        PATCH, seed=1).cuda(), 3)
    m.load_state_dict(fresh.state_dict())
    with torch.inference_mode():
        got, want = m(x), fresh(x)
    if torch.equal(got, before) or not torch.equal(got, want):
        raise AssertionError("weights loaded after a forward did not take "
                             "effect: the prepared operands are stale")
    log("[model] weights loaded after a forward: output equals a fresh "
        "model's bit for bit")
    del fresh, got, want


def busy_span(events):
    """(busy, window) in us of profiler device events: the union of their
    intervals, and the span from the first start to the last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy, end - spans[0][0]


def profile_forward(state, m, x, reps=3):
    """One torch.profiler pass over ``reps`` batch-32 forwards: the device's
    busy share (the union of kernel intervals over the span from the first
    kernel's start to the last one's end) and the summed time of the conv
    kernel's launches (conv_wgmma, splitk_reduce, conv_fma)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        m(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                m(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    if not kernels:
        log("[model] profiler: no device time recorded (CUDA events above "
            "stand)")
        return
    busy, window = busy_span(kernels)
    ours = sum(e.time_range.end - e.time_range.start for e in kernels
               if any(k in e.name for k in ("conv_wgmma", "splitk_reduce",
                                             "conv_fma")))
    log(f"[model] profiler over {reps} batch-32 forwards: device busy "
        f"{busy / window:.3f} of {window / 1e3 / reps:.2f} ms per forward; "
        f"kernels {busy / 1e3 / reps:.2f} ms per forward, of which the conv "
        f"kernel {ours / 1e3 / reps:.2f} ms; {len(kernels)} kernel events "
        f"| {state['smi']}")


def tile_input():
    """A normalized (1, 4352, 4352, 3) supertile with its halo, drawn on
    the card."""
    import torch

    from digipathai_tpu_torch.ops.color import normalize_patches

    g = torch.Generator(device="cuda").manual_seed(2)
    u8 = torch.randint(0, 256, (1, TILE_SIDE, TILE_SIDE, 3), generator=g,
                       device="cuda", dtype=torch.uint8)
    return normalize_patches(u8)


def tile_forward(state):
    """One tile-mode forward: a (1, 4352, 4352, 3) supertile with its halo
    through fused_stages=5, then the same with fused_up_stage patched to
    its plain version (the dense layers' conv kernel runs in both)."""
    import torch

    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops import stage_fused

    m = build_model("dense", dtype=torch.bfloat16, fused_stages=5).init(
        PATCH, seed=0).cuda()
    with torch.inference_mode():
        x = tile_input()
        reset_launches()
        p = m(x)[..., 1]
        torch.cuda.synchronize()
        n = read_launches()
        with mock.patch.object(stage_fused, "fused_up_stage",
                               stage_fused.fused_up_stage_plain):
            q = m(x)[..., 1]
            t_p = time_ms(lambda: m(x), reps=3, warmup=1)
        t_k = time_ms(lambda: m(x), reps=3, warmup=1)
        d = (p - q).abs()
        dmax, dmean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(p).all())
    want = {"fused_conv3x3": 58, "fused_up_stage": 5, "bilateral_message": 0}
    if n != want:
        raise AssertionError(f"tile forward launched {n}, want {want}")
    if tuple(p.shape) != (1, TILE_SIDE, TILE_SIDE) or not finite:
        raise AssertionError(f"bad tile forward output {tuple(p.shape)}")
    log(f"[model] tile forward (1,{TILE_SIDE},{TILE_SIDE},3) bf16 with "
        f"fused_stages=5: launches {n}; fused_up_stage vs plain max|dp|="
        f"{dmax:.4e} mean|dp|={dmean:.4e} (bound {MODEL_BOUND}); forward "
        f"{t_k:.2f} ms through the kernels, {t_p:.2f} ms with the plain "
        f"stage | {state['smi']}")
    if dmax > MODEL_BOUND:
        raise AssertionError(f"tile forward max|dp| {dmax} > {MODEL_BOUND}")
    del m, x, p, q, d
    torch.cuda.empty_cache()


def small_input_check(state):
    """The two new models on the card against the CPU, in f32 with TF32 off,
    on one (2, 64, 64, 3) input and the same weights: Inception through the
    conv kernel (its scalar f32 path) against the plain version on the CPU,
    DeepLab (cuDNN) against the CPU's convolutions, and DeepLab's windowed
    image pooling at 128^2."""
    import torch

    from digipathai_tpu_torch.models.registry import build_model

    prev = no_tf32()
    try:
        g = torch.Generator().manual_seed(4)
        for name, side, kw in (("inception", 64, {}),
                               ("deeplabv3", 64, {}),
                               ("deeplabv3", 128, {"aspp_pool_window": 64})):
            cpu = build_model(name, dtype=torch.float32, **kw).init(
                PATCH, seed=3)
            card = build_model(name, dtype=torch.float32,
                               **kw).module.cuda().eval()
            card.load_state_dict(cpu.state_dict())
            x = torch.rand(2, side, side, 3, generator=g) * 2 - 1
            with torch.inference_mode():
                want = cpu(x)
                got = card(x.cuda()).cpu()
            err = (got - want).abs().max().item()
            log(f"[model] {name} {kw or ''} f32 (2,{side},{side},3), card vs "
                f"CPU: max|dp|={err:.3e} (bound {F32_MODEL_BOUND})")
            if not err <= F32_MODEL_BOUND or not torch.isfinite(got).all():
                raise AssertionError(f"{name} card vs CPU max|dp| {err}")
            del cpu, card
    finally:
        restore_tf32(prev)


def inception_forwards(state, x):
    """The Inception U-Net at batch 32 x 256^2 (10 conv launches) and at
    (1, 4352, 4352, 3) with fused_stages=5 (5 stage launches, no conv),
    each through the kernels and through their plain versions; returns the
    model."""
    import torch

    from digipathai_tpu_torch.models.inception_unet import kernel_calls
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    m = build_model("inception", dtype=torch.bfloat16).init(
        PATCH, seed=0).cuda()
    for tag, fused, inp, convs, stages in (
            ("batch-32", 0, lambda: x, 10, 0), ("tile", 5, tile_input, 0, 5)):
        xi = inp()
        m.fused_stages = fused
        calls = kernel_calls(xi.shape[0], xi.shape[1], fused)
        want = {"fused_conv3x3": convs, "fused_up_stage": stages,
                "bilateral_message": 0}
        if [sum(c for k, _, c in calls if k == kind)
                for kind in ("conv", "stage")] != [convs, stages]:
            raise AssertionError(f"kernel_calls lists {calls}")
        with torch.inference_mode():
            reset_launches()
            p = m(xi)[..., 1]
            torch.cuda.synchronize()
            n = read_launches()
            with mock.patch.object(conv_fused, "fused_conv3x3",
                                   conv_fused.fused_conv3x3_plain), \
                    mock.patch.object(stage_fused, "fused_up_stage",
                                      stage_fused.fused_up_stage_plain):
                q = m(xi)[..., 1]
                t_p = time_ms(lambda: m(xi), reps=3, warmup=1)
            t_k = time_ms(lambda: m(xi), reps=3, warmup=1)
            d = (p - q).abs()
            dmax, dmean = d.max().item(), d.mean().item()
            finite = bool(torch.isfinite(p).all())
        if n != want:
            raise AssertionError(f"Inception {tag} forward launched {n}, "
                                 f"want {want}")
        if tuple(p.shape) != tuple(xi.shape[:3]) or not finite:
            raise AssertionError(f"bad Inception output {tuple(p.shape)}")
        log(f"[model] Inception-ResNet-v2-U-Net bf16 {tag} "
            f"{tuple(xi.shape)} fused_stages={fused}: launches {n}; kernels "
            f"vs plain max|dp|={dmax:.4e} mean|dp|={dmean:.4e} (bound "
            f"{MODEL_BOUND}); forward {t_k:.2f} ms through the kernels, "
            f"{t_p:.2f} ms plain | {state['smi']}")
        if dmax > MODEL_BOUND:
            raise AssertionError(f"Inception {tag} max|dp| {dmax}")
        del xi, p, q, d
        torch.cuda.empty_cache()
    m.fused_stages = 0
    return m


def deeplab_forwards(state, x):
    """DeepLabv3+ at batch 32 x 256^2 and at (1, 4352, 4352, 3) with
    aspp_pool_window=256 (tile mode's patch-sized image pooling, the same
    weights): shapes, finite values, no hand-written kernel launched, and
    the forward's time; returns the batch-32 model."""
    import torch

    from digipathai_tpu_torch.models.registry import build_model

    m = build_model("deeplabv3", dtype=torch.bfloat16).init(
        PATCH, seed=0).cuda()
    mt = build_model("deeplabv3", dtype=torch.bfloat16,
                     aspp_pool_window=PATCH).module.cuda().eval()
    mt.load_state_dict(m.state_dict())
    zero = {"fused_conv3x3": 0, "fused_up_stage": 0, "bilateral_message": 0}
    for tag, model, inp in (("batch-32", m, lambda: x),
                            (f"tile aspp_pool_window={PATCH}", mt,
                             tile_input)):
        xi = inp()
        with torch.inference_mode():
            reset_launches()
            p = model(xi)[..., 1]
            torch.cuda.synchronize()
            n = read_launches()
            t = time_ms(lambda: model(xi), reps=3, warmup=1)
            finite = bool(torch.isfinite(p).all())
            lo, hi = p.min().item(), p.max().item()
        if n != zero or tuple(p.shape) != tuple(xi.shape[:3]) or not finite:
            raise AssertionError(f"DeepLab {tag}: launches {n}, output "
                                 f"{tuple(p.shape)}, finite {finite}")
        log(f"[model] DeepLabv3+ bf16 {tag} {tuple(xi.shape)}: p in "
            f"[{lo:.4f}, {hi:.4f}]; forward {t:.2f} ms (cuDNN and PyTorch "
            f"ops, no hand-written kernel) | {state['smi']}")
        del xi, p
        torch.cuda.empty_cache()
    del mt
    return m


def kernels_under(e):
    """Device time (us) of the kernels launched inside profiler CPU event
    e."""
    return (sum(k.duration for k in e.kernels if not k.name.startswith(
        "dpai_")) + sum(kernels_under(c) for c in e.cpu_children))


def profile_ensemble(state, models, x, reps=2):
    """One torch.profiler pass over ``reps`` batch-32 ensemble forwards
    (each model once per forward, as the patch step runs them with the
    default TTA): the device's busy share and each model's share of the
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.inference_mode():
        for m in models.values():
            m(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for name, m in models.items():
                    with record_function(f"dpai_{name}"):
                        m(x)
            torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.time_range.end > e.time_range.start
               and not e.name.startswith("dpai_")]
    if not kernels:
        raise AssertionError("profiler recorded no device time in the "
                             "ensemble forward")
    busy, window = busy_span(kernels)
    per = {name: sum(kernels_under(e) for e in events
                     if e.name == f"dpai_{name}"
                     and e.device_type == DeviceType.CPU) / 1e3 / reps
           for name in models}
    total = sum(per.values())
    log(f"[model] profiler over {reps} batch-32 ensemble forwards: device "
        f"busy {busy / window:.3f} of {window / 1e3 / reps:.2f} ms per "
        f"ensemble forward; kernels {busy / 1e3 / reps:.2f} ms, of which "
        + ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})"
                    for k, v in per.items())
        + f"; {len(kernels)} kernel events | {state['smi']}")


def randomize_bn(module, seed):
    """BatchNorm statistics and affines, and conv biases, away from their
    initial values, drawn on the module's device, so that folding changes
    every folded conv."""
    import torch

    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith(("scale", "var")):
                t.copy_(torch.rand(t.shape, generator=g, device=dev) + 0.5)
            elif name.endswith(("mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.1)
    return module


def equal_states(a, b) -> int:
    """The number of tensors in two modules' states, after checking that
    they hold the same names and the same values bit for bit."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    if sa.keys() != sb.keys():
        raise AssertionError("state names differ")
    for k in sa:
        if not torch.equal(sa[k].cpu(), sb[k].cpu()):
            raise AssertionError(f"{k} differs")
    return len(sa)


def phase_weights(state):
    """Trained-weight loading onto the card.  Each model's seeded weights
    (BatchNorms away from identity) are written as the liver family's
    checkpoint with the port's own writers: the ``.h5``
    (``convert_h5.write_keras_h5``) when h5py imports, else the converted
    ``.npz`` cache (``weights.save_converted``).  ``load_variables`` loads
    the ``.h5`` (writing the cache), then the cache alone; each load, moved
    to the card, equals the seeded module bit for bit.  Phase 5 runs dense
    from these weights."""
    import torch

    from digipathai_tpu_torch.models import weights
    from digipathai_tpu_torch.models.bridge import torch_to_flax
    from digipathai_tpu_torch.models.registry import build_model

    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    for i, name in enumerate(("dense", "inception", "deeplabv3")):
        seeded = randomize_bn(build_model(name).init(PATCH, seed=20 + i),
                              30 + i).cuda()
        routes = []
        if have_h5py:
            from digipathai_tpu_torch.models.convert_h5 import write_keras_h5

            h5 = weights.h5_path("liver", name)
            h5.parent.mkdir(parents=True, exist_ok=True)
            write_keras_h5(h5, torch_to_flax(seeded))
            status = {}
            got = weights.load_variables(build_model(name), "liver", name,
                                         status=status).cuda()
            equal_states(got, seeded)
            if "weights" in status or not weights.converted_path(
                    "liver", name).exists():
                raise AssertionError(f"{name}: the .h5 did not load")
            routes.append(".h5")
        else:
            weights.save_converted(seeded, weights.converted_path("liver",
                                                                  name))
        got = weights.load_variables(build_model(name), "liver", name).cuda()
        n = equal_states(got, seeded)
        routes.append(".npz cache")
        log(f"[weights] {name}: loaded onto the card from "
            f"{' then '.join(routes)}; {n} tensors equal to the seeded "
            f"module's bit for bit"
            + ("" if have_h5py else " (h5py absent: the .h5 route did "
               "not run)"))
        del seeded, got
    torch.cuda.empty_cache()


def forward_counts(model, x):
    """(p(class 1), {kernel: launches}, {int8 route: convs}) of one forward,
    every count set to 0 just before it."""
    import torch

    from digipathai_tpu_torch.models import quant

    routes = quant.int8_conv.routes
    for k in routes:
        routes[k] = 0
    with torch.inference_mode():
        reset_launches()
        p = model(x)[..., 1]
        torch.cuda.synchronize()
        n = read_launches()
    return p, n, {k: v for k, v in routes.items() if v}


def no_tf32():
    """Turn TF32 off for cuDNN and cuBLAS; returns the previous switches."""
    import torch

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return prev


def restore_tf32(prev):
    import torch

    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def phase_fold(state):
    """fold_bn on the card: each model at batch 32 x 256^2, BatchNorms away
    from identity, folded (``fold_module``, in place, after a forward)
    against unfolded, in bf16 (bound FOLD_BF16) and in f32 with TF32 off
    (bound FOLD_F32); the same kernel launches either way."""
    import torch

    from digipathai_tpu_torch.models.fold_bn import fold_module
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops.color import normalize_patches

    g = torch.Generator(device="cuda").manual_seed(5)
    x8 = torch.randint(0, 256, (BATCH, PATCH, PATCH, 3), generator=g,
                       device="cuda", dtype=torch.uint8)
    for i, name in enumerate(("dense", "inception", "deeplabv3")):
        for dt, bound in ((torch.bfloat16, FOLD_BF16),
                          (torch.float32, FOLD_F32)):
            prev = no_tf32() if dt == torch.float32 else None
            try:
                m = randomize_bn(build_model(name, dtype=dt).init(
                    PATCH, seed=i).cuda(), 40 + i)
                x = normalize_patches(x8, dtype=dt)
                p, n, _ = forward_counts(m, x)
                with torch.inference_mode():
                    t0 = time_ms(lambda: m(x), reps=3, warmup=1)
                folds = fold_module(m)
                q, nf, _ = forward_counts(m, x)
                with torch.inference_mode():
                    t1 = time_ms(lambda: m(x), reps=3, warmup=1)
            finally:
                if prev is not None:
                    restore_tf32(prev)
            d = (p.float() - q.float()).abs().max().item()
            log(f"[fold] {name} {str(dt)[6:]} ({BATCH},{PATCH},{PATCH},3): "
                f"{folds} conv->BN pairs folded; folded vs unfolded "
                f"max|dp|={d:.3e} (bound {bound}); forward {t1:.2f} ms "
                f"folded, {t0:.2f} ms unfolded; launches {nf} "
                f"| {state['smi']}")
            if not d <= bound or n != nf or not torch.isfinite(q).all():
                raise AssertionError(f"fold_bn {name} {dt}: max|dp| {d}, "
                                     f"launches {n} vs {nf}")
            del m, x, p, q
            torch.cuda.empty_cache()


def replay_int8(model, x):
    """Every int8 conv of one forward of ``model`` on the card, replayed by
    a CPU copy of the model (the exact f64 route) on the same input:
    ({route: convs}, the largest difference over its output's scale)."""
    import copy

    import torch

    from digipathai_tpu_torch.models import quant
    from digipathai_tpu_torch.models.unet_decoder import PreparedModule

    routes = quant.int8_conv.routes
    real = PreparedModule._qconv
    calls = []

    def spy(self, xi, name, stride=1, same=True):
        before = dict(routes)
        y = real(self, xi, name, stride, same)
        route = next(k for k in routes if routes[k] != before[k])
        calls.append((name, xi.cpu(), stride, same, y.cpu(), route))
        return y

    PreparedModule._qconv = spy
    try:
        with torch.inference_mode():
            model(x)
    finally:
        PreparedModule._qconv = real
    cpu = copy.deepcopy(model).cpu()
    cpu._prepared = {}
    worst, per = 0.0, {}
    with torch.inference_mode():
        for name, xi, stride, same, y, route in calls:
            want = real(cpu, xi, name, stride, same).float()
            err = (y.float() - want).abs().max().item()
            worst = max(worst, err / max(want.abs().max().item(), 1e-30))
            per[route] = per.get(route, 0) + 1
    return per, worst


def pinned_f32(card, cpu, x):
    """p (class 1) of ``card``'s f32 forward of ``x`` and of ``cpu``'s with
    each int8 conv fed the card's input at that layer, and the largest
    difference of the CPU's own int8 inputs from the card's over their
    scale."""
    import torch

    from digipathai_tpu_torch.models.unet_decoder import PreparedModule

    real = PreparedModule._qconv
    seen, worst = {}, [0.0]

    def record(self, xi, name, stride=1, same=True):
        seen[name] = xi.cpu()
        return real(self, xi, name, stride, same)

    def pin(self, xi, name, stride=1, same=True):
        ref = seen.pop(name)
        worst[0] = max(worst[0], (xi - ref).abs().max().item()
                       / max(ref.abs().max().item(), 1e-30))
        return real(self, ref, name, stride, same)

    try:
        with torch.inference_mode():
            PreparedModule._qconv = record
            got = card(x.cuda())[..., 1].cpu()
            PreparedModule._qconv = pin
            want = cpu(x)[..., 1]
    finally:
        PreparedModule._qconv = real
    if seen:
        raise AssertionError(f"int8 convs the CPU did not run: {list(seen)}")
    return got, want, worst[0]


def quant_models(name, mode, fused):
    """(exact, quantized) bf16 models on the card with the same seeded
    weights, DeepLab's also windowed for tile mode."""
    import torch

    from digipathai_tpu_torch.models.registry import build_model

    kw = {"fused_stages": fused} if name == "dense" else {}
    exact = build_model(name, dtype=torch.bfloat16, **kw).init(
        PATCH, seed=50).cuda()
    quantized = build_model(name, dtype=torch.bfloat16, quantized=mode,
                            **kw).module.cuda().eval()
    quantized.load_state_dict(exact.state_dict())
    return exact, quantized


def phase_quant(state):
    """The int8 quantized forwards on the card: dense with
    ``quantized=True`` (dynamic) and DeepLab with ``"static"`` after
    ``calibrate`` on the card.  For each: the f32 forward (TF32 off) on the
    card against the CPU's on a (2, 64, 64, 3) input with the same ranges,
    the CPU's int8 convs fed the card's inputs (bound QUANT_F32); every int8 conv of a (2, 256, 256, 3) bf16 forward
    replayed exactly on the CPU (bound INT8_REL, per route); at batch 32 x
    256^2 and at the 4352^2 tile (dense with fused_stages=5, DeepLab
    windowed at 256), the quantized forward beside the exact one: max|dp|,
    ms, kernel launches and int8 convs per route."""
    import torch

    from digipathai_tpu_torch.models import densenet_unet
    from digipathai_tpu_torch.models.quant import calib_of, calibrate, set_calib
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops.color import normalize_patches

    g = torch.Generator(device="cuda").manual_seed(6)
    x32 = normalize_patches(torch.randint(
        0, 256, (BATCH, PATCH, PATCH, 3), generator=g, device="cuda",
        dtype=torch.uint8))
    xs = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(7))
    xs = xs * 2 - 1
    for name, mode in (("dense", True), ("deeplabv3", "static")):
        # f32, card vs CPU
        cpu = build_model(name, dtype=torch.float32, quantized=mode).init(
            PATCH, seed=51)
        card = build_model(name, dtype=torch.float32, quantized=mode
                           ).module.cuda().eval()
        card.load_state_dict(cpu.state_dict())
        prev = no_tf32()
        try:
            if mode == "static":
                calibrate(card, [xs.cuda()])
                set_calib(cpu, calib_of(card))
            got, want, seg = pinned_f32(card, cpu, xs)
        finally:
            restore_tf32(prev)
        err = (got - want).abs().max().item()
        log(f"[quant] {name} quantized={mode!r} f32 (2,64,64,3), card vs "
            f"CPU, int8 inputs pinned to the card's: max|dp|={err:.3e}, "
            f"int8 inputs max|d| {seg:.3e} of their scale (bound "
            f"{QUANT_F32} each)")
        if not (err <= QUANT_F32 and seg <= QUANT_F32
                and torch.isfinite(got).all()):
            raise AssertionError(f"{name} quantized card vs CPU: {err}, "
                                 f"inputs {seg}")
        del cpu, card

        exact, qm = quant_models(name, mode, 0)
        if mode == "static":
            calibrate(qm, [x32[:8]])
        per, worst = replay_int8(qm, x32[:2])
        log(f"[quant] {name}: the int8 convs of a (2,{PATCH},{PATCH},3) "
            f"bf16 forward replayed on the CPU (f64): {per}, max|d| "
            f"{worst:.3e} of the output scale (bound {INT8_REL})")
        if not worst <= INT8_REL:
            raise AssertionError(f"{name} int8 replay: {worst}")
        rows = []
        for tag, xi in (("batch-32", lambda: x32), ("tile", tile_input)):
            xin = xi()
            if tag == "tile" and name == "dense":
                exact.fused_stages = qm.fused_stages = 5
            elif tag == "tile":
                # tile mode's DeepLab: the same weights and ranges, pooling
                # patch-sized windows
                sd, calib = exact.state_dict(), calib_of(qm)
                exact, qm = (build_model(
                    name, dtype=torch.bfloat16, aspp_pool_window=PATCH,
                    quantized=m_).module.cuda().eval() for m_ in (False, mode))
                exact.load_state_dict(sd)
                qm.load_state_dict(sd)
                set_calib(qm, calib)
            p, ne, _ = forward_counts(exact, xin)
            q, nq, routes = forward_counts(qm, xin)
            if name == "dense":
                n, side = xin.shape[:2]
                want = {k: sum(c for kind, _, c in densenet_unet.kernel_calls(
                    n, side, exact.fused_stages, quantized=True)
                    if kind == k) for k in ("conv", "stage")}
                if (nq["fused_conv3x3"], nq["fused_up_stage"]) != (
                        want["conv"], want["stage"]):
                    raise AssertionError(f"quantized dense {tag} launched "
                                         f"{nq}, want {want}")
            elif any(nq.values()):
                raise AssertionError(f"DeepLab launched {nq}")
            with torch.inference_mode():
                te = time_ms(lambda: exact(xin), reps=3, warmup=1)
                tq = time_ms(lambda: qm(xin), reps=3, warmup=1)
            d = (p.float() - q.float()).abs()
            finite = bool(torch.isfinite(q).all())
            log(f"[quant] {name} quantized={mode!r} bf16 {tag} "
                f"{tuple(xin.shape)}: quantized vs exact max|dp|="
                f"{d.max().item():.4e} mean|dp|={d.mean().item():.4e}; "
                f"forward {tq:.2f} ms quantized, {te:.2f} ms exact; "
                f"launches {nq} (exact {ne}); int8 convs per route "
                f"{routes} | {state['smi']}")
            if not finite or not routes:
                raise AssertionError(f"{name} {tag}: finite {finite}, "
                                     f"routes {routes}")
            rows.append((tag, nq))
            del xin, p, q, d
            torch.cuda.empty_cache()
        state.setdefault("quant_launches", {})[name] = dict(rows)
        del exact, qm
        torch.cuda.empty_cache()


def reset_launches():
    """Set every kernel's launch count to 0 (a main path starts here)."""
    from digipathai_tpu_torch.ops import bilateral, conv_fused, stage_fused

    conv_fused.fused_conv3x3.launches = 0
    stage_fused.fused_up_stage.launches = 0
    bilateral.bilateral_message.launches = 0


def read_launches() -> dict:
    from digipathai_tpu_torch.ops import bilateral, conv_fused, stage_fused

    return {"fused_conv3x3": conv_fused.fused_conv3x3.launches,
            "fused_up_stage": stage_fused.fused_up_stage.launches,
            "bilateral_message": bilateral.bilateral_message.launches}


def tissue_tiles(plan, supertile) -> int:
    """Supertiles of the map that a planned patch overlaps: the tiles whose
    probability map is not all 0, which the CRF refines."""
    X, Y = plan.slide_dims
    tiles = set()
    for g in plan.groups:
        for x, y in g.coords[g.valid].tolist():
            for ty in range(y // supertile,
                            (min(y + PATCH, Y) - 1) // supertile + 1):
                for tx in range(x // supertile,
                                (min(x + PATCH, X) - 1) // supertile + 1):
                    tiles.add((ty, tx))
    return len(tiles)


def phase_engine(state):
    import numpy as np
    import torch

    import digipathai_tpu_torch as dpt
    from digipathai_tpu_torch.engine.planner import plan_patches
    from digipathai_tpu_torch.io.tiff_py import TiffReader

    d = os.path.join(state["tmp"], "engine")
    os.makedirs(d)
    path = os.path.join(d, "smoke-slide.tiff")
    t = time.time()
    meta = make_synthetic_slide(path, SLIDE[0], SLIDE[1], seed=0)
    log(f"[engine] synthetic slide {SLIDE[0]}x{SLIDE[1]} written in "
        f"{time.time() - t:.1f} s")
    with dpt.Slide(path) as s:
        plan = plan_patches(s, patch=PATCH, stride=128, batch=BATCH)

    def run(model, tag, slide=path, dims=SLIDE, quick=True, mode="colon",
            **kw):
        outs = {k: os.path.join(d, f"{tag}-{k}.tiff")
                for k in ("probs", "mask", "uncertainty")}
        status, batches = {}, []
        t0 = time.time()
        mask = dpt.getSegmentation(
            slide, probs_path=outs["probs"], mask_path=outs["mask"],
            uncertainty_path=outs["uncertainty"], status=status, quick=quick,
            model=model, mode=mode,
            progress_cb=lambda done, total: batches.append(done), **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if mask.shape != dims or not set(mask.ravel()[::997]) <= {0, 255}:
            raise AssertionError(f"{model}: bad mask {mask.shape}")
        for p in outs.values():
            with dpt.Slide(p) as s:
                if s.dimensions != dims:
                    raise AssertionError(f"{p}: dimensions {s.dimensions}")
        return mask, status, len(batches), wall

    # the dense main path, then the same with the CRF post-pass; each run
    # starts with every launch count at 0 and reads them at its end
    n_iters, supertile = 10, 4096  # getSegmentation's CRF defaults
    want_bil = n_iters * tissue_tiles(plan, supertile)
    state["launches"], state["launches_dense"] = {}, {}
    walls = {}
    for crf in (False, True):
        reset_launches()
        _, status, nb, wall = run("dense", f"dense-crf{int(crf)}", crf=crf)
        got = read_launches()
        want = {"fused_conv3x3": 68 * nb, "fused_up_stage": 0,
                "bilateral_message": want_bil if crf else 0}
        if nb != plan.total_batches or got != want:
            raise AssertionError(f"crf={crf}: launches {got}, want {want} "
                                 f"({nb} batches; plan {plan.total_batches})")
        if status.get("weights") != "random":
            raise AssertionError(f"weights status {status.get('weights')!r}")
        if crf:
            state["launches_dense"]["bilateral_message"] = \
                got["bilateral_message"]
        else:
            state["launches_dense"]["fused_conv3x3"] = got["fused_conv3x3"]
        walls[crf] = wall
        log(f"[engine] dense patch mode crf={crf}: {plan.total_patches} "
            f"patches, {nb} batches of {BATCH}, {len(plan.groups)} "
            f"supertiles, launches {got}; wall {wall:.2f} s = "
            f"{plan.total_patches / wall:.1f} patches/s; stages "
            f"{status['timings']} | {state['smi']}")
    profile_crf(state, path, os.path.join(d, "dense-crf0-probs.tiff"),
                supertile)
    log(f"[engine] CRF post-pass: {want_bil // n_iters} tissue supertiles, "
        f"{state['launches_dense']['bilateral_message']} bilateral launches; "
        f"e2e {walls[False]:.2f} s without crf, {walls[True]:.2f} s with "
        f"| {state['smi']}")

    # tile mode: one (1, 4352, 4352, 3) forward per tissue supertile, its
    # five decoder stages on fused_up_stage, and with crf=True each
    # supertile refined at its flush
    n_tiles = len(plan.groups)
    for crf in (False, True):
        reset_launches()
        _, status, ng, wall = run("dense", f"dense-tile-crf{int(crf)}",
                                  crf=crf, inference_mode="tile",
                                  fused_stages=5)
        got = read_launches()
        want = {"fused_conv3x3": 58 * n_tiles, "fused_up_stage": 5 * n_tiles,
                "bilateral_message": n_iters * n_tiles if crf else 0}
        if ng != n_tiles or got != want:
            raise AssertionError(f"tile crf={crf}: launches {got}, want "
                                 f"{want} ({ng} supertiles done of "
                                 f"{n_tiles})")
        if not crf:
            state["launches_dense"]["fused_up_stage"] = got["fused_up_stage"]
        log(f"[engine] dense tile mode fused_stages=5 crf={crf}: {n_tiles} "
            f"supertile forwards at {TILE_SIDE}^2, launches {got}; wall "
            f"{wall:.2f} s = {plan.total_patches / wall:.1f} equivalent "
            f"patches/s ({plan.total_patches} planned stride-128 patches); "
            f"stages {status['timings']} | {state['smi']}")

    # the 3-model ensemble (quick=False, the viewer's full-quality
    # request): per batch the dense model's 68 conv launches and
    # Inception's 10; per tissue supertile in tile mode the dense model's
    # 58 conv and 5 stage launches and Inception's 5 stage launches, and
    # with crf=True n_iters bilateral launches
    for mode, crf in (("patch", False), ("tile", False), ("tile", True)):
        reset_launches()
        _, status, nb, wall = run(
            "dense", f"ensemble-{mode}-crf{int(crf)}", quick=False, crf=crf,
            inference_mode=mode, fused_stages=5)
        got = read_launches()
        if mode == "patch":
            want = {"fused_conv3x3": 78 * nb, "fused_up_stage": 0,
                    "bilateral_message": 0}
            done, total = nb, plan.total_batches
        else:
            want = {"fused_conv3x3": 58 * n_tiles,
                    "fused_up_stage": 10 * n_tiles,
                    "bilateral_message": n_iters * n_tiles if crf else 0}
            done, total = nb, n_tiles
        if done != total or got != want:
            raise AssertionError(f"ensemble {mode} crf={crf}: launches "
                                 f"{got}, want {want} ({done} of {total})")
        if crf:
            state["launches"]["bilateral_message"] = got["bilateral_message"]
        elif mode == "patch":
            state["launches"]["fused_conv3x3"] = got["fused_conv3x3"]
        else:
            state["launches"]["fused_up_stage"] = got["fused_up_stage"]
        unit = "patches/s" if mode == "patch" else "equivalent patches/s"
        log(f"[engine] ensemble (quick=False) {mode} mode fused_stages=5 "
            f"crf={crf}: {plan.total_patches} planned patches, "
            f"{nb} {'batches' if mode == 'patch' else 'supertiles'}, "
            f"launches {got}; wall {wall:.2f} s = "
            f"{plan.total_patches / wall:.1f} {unit}; stages "
            f"{status['timings']} | {state['smi']}")

    # the ensemble in tile mode with DeepLab static int8 (calibrated on the
    # first supertile's patches first), dense with fold_bn in patch mode,
    # and dense from the weights phase_weights wrote (the liver family)
    for tag, kw, per in (
            ("ensemble tile quantized=deeplabv3:static",
             dict(quick=False, inference_mode="tile", fused_stages=5,
                  quantized="deeplabv3:static"),
             {"fused_conv3x3": 58, "fused_up_stage": 10}),
            ("dense patch fold_bn=True", dict(fold_bn=True),
             {"fused_conv3x3": 68, "fused_up_stage": 0}),
            ("dense patch, trained weights from the written checkpoint",
             dict(mode="liver"), {"fused_conv3x3": 68, "fused_up_stage": 0})):
        reset_launches()
        _, status, nb, wall = run("dense", tag.split(",")[0].replace(
            " ", "-").replace(":", "-").replace("=", "-"), **kw)
        got = read_launches()
        tile = kw.get("inference_mode") == "tile"
        units = n_tiles if tile else plan.total_batches
        want = {k: v * units for k, v in per.items()}
        want["bilateral_message"] = 0
        if nb != units or got != want:
            raise AssertionError(f"{tag}: launches {got}, want {want} "
                                 f"({nb} of {units})")
        random = status.get("weights") == "random"
        if random != (kw.get("mode") != "liver"):
            raise AssertionError(f"{tag}: weights status "
                                 f"{status.get('weights')!r}")
        unit = "equivalent patches/s" if tile else "patches/s"
        log(f"[engine] {tag}: {plan.total_patches} planned patches, {nb} "
            f"{'supertiles' if tile else 'batches'}, launches {got}, weights "
            f"{'random' if random else 'loaded'}; wall {wall:.2f} s = "
            f"{plan.total_patches / wall:.1f} {unit}; stages "
            f"{status['timings']} | {state['smi']}")

    # the oracle model's segmentation is known: the slide's lesion
    lesion = meta["lesion_mask"]
    masks = {}
    for mode, crf, floor in (("patch", False, 0.7), ("patch", True, 0.6),
                             ("tile", False, 0.7)):
        mask, status, _, wall = run("oracle", f"oracle-{mode}-crf{int(crf)}",
                                    crf=crf, inference_mode=mode)
        got = mask.T > 0
        masks[mode, crf] = got
        iou = (got & lesion).sum() / max((got | lesion).sum(), 1)
        log(f"[engine] oracle {mode} mode crf={crf}: lesion IoU {iou:.3f} "
            f"(bound {floor}), wall {wall:.2f} s, stages {status['timings']}")
        if iou <= floor:
            raise AssertionError(f"oracle {mode} crf={crf} lesion IoU {iou}")
    # a pointwise model: tile mode computes every pixel patch mode does
    missed = int((masks["patch", False] & ~masks["tile", False]).sum())
    if missed:
        raise AssertionError(f"{missed} patch-mode positives are negative "
                             f"in tile mode")

    # the oracle CRF run on the card and on the CPU, in f32, with cuDNN's
    # TF32 switch as users have it (on, PyTorch's default): the CRF's own
    # guard must keep its blurs in f32, and restore the switch
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is off before the CRF check")
    small = os.path.join(d, "small-slide.tiff")
    make_synthetic_slide(small, 1024, 1024, seed=3)
    maps, masks = {}, {}
    for dev in ("cuda", "cpu"):
        masks[dev], status, _, wall = run(
            "oracle", f"small-{dev}", slide=small, dims=(1024, 1024),
            crf=True, device=dev, compute_dtype=torch.float32,
            save_float_probs=True)
        with TiffReader(os.path.join(d, f"small-{dev}-probs.tiff.f32.tiff")) as r:
            maps[dev] = np.asarray(r.read_whole(0), np.float32).squeeze()
        log(f"[engine] oracle crf=True 1024^2 on {dev}: wall {wall:.2f} s, "
            f"stages {status['timings']}")
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the CRF left cuDNN's TF32 switch off")
    err = float(np.abs(maps["cuda"] - maps["cpu"]).max())
    sure = np.abs(maps["cpu"].T - 0.3) > 1e-3
    flips = int((masks["cuda"] != masks["cpu"])[sure].sum())
    log(f"[engine] oracle CRF card vs CPU: max|dp| {err:.3e} (bound "
        f"{CRF_DEVICE_BOUND}), {flips} mask flips away from the threshold")
    if not err <= CRF_DEVICE_BOUND or flips:
        raise AssertionError(f"CRF card vs CPU: max|dp| {err}, {flips} flips")


def profile_crf(state, slide_path, probs_path, supertile):
    """One torch.profiler pass over the CRF post-pass's work on one tissue
    supertile, as ``refine_slide_crf`` and the engine's write-back do it:
    read the region, ``refine_tile`` (upload, ten mean-field iterations,
    download), stage the refined block to an .npz and write it into a
    memmap.  Splits the device time into the bilateral kernel, the blurs
    (the kernels under ``_blur2d``, traced as a profiler range), the copies
    and all other kernels, and the wall into its host steps.  It observes
    only: the engine's code is called as it is."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import digipathai_tpu_torch as dpt
    from digipathai_tpu_torch.ops import crf

    st = supertile
    with dpt.Slide(probs_path) as s:
        probs = np.asarray(s.read_region((0, 0), 0, (st, st)))[..., 0]
    probs = probs.astype(np.float32) / 255.0
    mm = np.lib.format.open_memmap(os.path.join(state["tmp"], "crf.npy"),
                                   mode="w+", dtype=np.float32,
                                   shape=(st, st))
    blur = crf._blur2d

    def traced_blur(*a, **k):
        with record_function("dpai_blur2d"):
            return blur(*a, **k)

    def read():
        with dpt.Slide(slide_path) as s:
            return np.asarray(s.read_region((0, 0), 0, (st, st)))

    crf.refine_tile(read(), probs, st)  # warm: cuDNN's choice, lazy loads
    torch.cuda.synchronize()
    with mock.patch.object(crf, "_blur2d", traced_blur), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = [time.perf_counter()]  # the profiler's start-up is outside
        img = read()
        t.append(time.perf_counter())
        refined = crf.refine_tile(img, probs, st)
        t.append(time.perf_counter())
        tmp = os.path.join(state["tmp"], "crftile.npz")
        np.savez(tmp, box=np.asarray((0, st, 0, st)), block=refined)
        t.append(time.perf_counter())
        mm[:, :] = refined
        mm.flush()
        t.append(time.perf_counter())
    events = prof.events()
    # device events: kernels and copies (not the range's own span on the
    # device timeline)
    dev = [e for e in events
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and e.time_range.end > e.time_range.start
           and e.name != "dpai_blur2d"]

    if not dev:
        raise AssertionError("profiler recorded no device time in the CRF")

    def summed(pred):
        return sum(e.time_range.end - e.time_range.start
                   for e in dev if pred(e.name)) / 1e6

    def is_copy(name):
        return "memcpy" in name.lower() or "memset" in name.lower()

    bil_s = summed(lambda n: "bilateral_kernel" in n)
    copy_s = summed(is_copy)
    all_s = summed(lambda n: True)
    blur_s = sum(kernels_under(e) for e in events
                 if e.name == "dpai_blur2d"
                 and e.device_type == DeviceType.CPU) / 1e6
    busy = busy_span(dev)[0] / 1e6
    names = {}
    for e in dev:
        names[e.name] = names.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    wall = t[-1] - t[0]
    log(f"[engine] CRF split, one {st}^2 supertile (profiled): wall "
        f"{wall:.4f} s = read {t[1] - t[0]:.4f} s + refine_tile "
        f"{t[2] - t[1]:.4f} s + npz staging {t[3] - t[2]:.4f} s + memmap "
        f"write-back {t[4] - t[3]:.4f} s; device: bilateral "
        f"{bil_s:.4f} s ({sum(1 for e in dev if 'bilateral_kernel' in e.name)}"
        f" launches), blurs {blur_s:.4f} s, copies {copy_s:.4f} s, other "
        f"kernels {all_s - bil_s - blur_s - copy_s:.4f} s; device busy "
        f"{busy:.4f} s, host-only {wall - busy:.4f} s "
        f"(of it inside refine_tile {t[2] - t[1] - busy:.4f} s) "
        f"| {state['smi']}")
    log("[engine] CRF split, top device events: " + "; ".join(
        f"{n[:60]} {v * 1e3:.2f} ms" for n, v in top))
    del mm


def phase_server(state):
    import threading
    import urllib.request

    from digipathai_tpu_torch.server import ServerConfig, create_app, serve

    d = os.path.join(state["tmp"], "serve")
    os.makedirs(d)
    make_synthetic_slide(os.path.join(d, "colon-smoke.tiff"), 2048, 1536,
                         seed=2)
    # fused_stages reaches the engine through engine_extra; patch mode's
    # batches of 32 take the canonical decoder, tile mode the stage kernel
    cfg = ServerConfig(slide_dir=d, viewer_only=False,
                       engine_extra={"fused_stages": 5})
    httpd = serve(create_app(cfg), host="127.0.0.1", port=0, quiet=True)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_port}"

    def get(path, data=None):
        with urllib.request.urlopen(base + path, data=data, timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
            return r.read()

    try:
        if b"colon-smoke.tiff" not in get("/"):
            raise AssertionError("slide not listed")
        get("/colon-smoke.tiff.dzi")
        get("/colon-smoke.tiff")  # the viewer page selects the slide
        for form, kernels in (
                (b"tissuetype=Colon&crf=1",
                 ("fused_conv3x3", "bilateral_message")),
                (b"tissuetype=Colon&crf=1&inference_mode=tile",
                 ("fused_conv3x3", "fused_up_stage", "bilateral_message")),
                (b"tissuetype=Colon&quick=0", ("fused_conv3x3",))):
            n0 = read_launches()
            get("/segment", data=form)
            t0 = time.time()
            while True:
                st = json.loads(get("/check_segment_status"))
                if st["status"] == "Done":
                    break
                if st["status"] == "Error" or time.time() - t0 > 600:
                    raise AssertionError(f"/segment {form}: {st}")
                time.sleep(0.5)
            dzi = get("/colon-smoke-dgai-mask.tiff.dzi")
            tile = get("/colon-smoke-dgai-mask.tiff_files/8/0_0.jpeg")
            if b'Width="2048"' not in dzi or tile[:2] != b"\xff\xd8":
                raise AssertionError("mask overlay not served")
            moved = {k: v - n0[k] for k, v in read_launches().items()}
            if sorted(k for k, v in moved.items() if v) != sorted(kernels):
                raise AssertionError(f"/segment {form} launched {moved}")
            log(f"[server] /segment {form.decode()} Done in "
                f"{time.time() - t0:.1f} s with launches {moved}; mask .dzi "
                f"and tile served ({len(tile)} bytes)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)


def main():
    import shutil

    import torch

    import digipathai_tpu_torch  # noqa: F401 - fails at once outside the repo

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    state = {}
    try:
        for phase in (phase_device, phase_build, phase_kernels, phase_model,
                      phase_weights, phase_fold, phase_quant, phase_engine,
                      phase_server):
            t = time.time()
            phase(state)
            log(f"[{phase.__name__[6:]}] done in {time.time() - t:.1f} s")
    finally:
        if "tmp" in state:
            shutil.rmtree(state["tmp"], ignore_errors=True)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "digipathai_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    kernels = []
    for name, key, src, tpu in (
            ("fused_conv3x3", "conv", "conv_fused.cu",
             "digipathai_tpu/ops/pallas/conv_fused.py:119"),
            ("fused_up_stage", "stage", "stage_fused.cu",
             "digipathai_tpu/ops/pallas/stage_fused.py:172"),
            ("bilateral_message", "bilateral", "bilateral.cu",
             "digipathai_tpu/ops/pallas/bilateral.py:104")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"digipathai_tpu_torch/csrc/{src}",
                        "replaces": tpu,
                        "launches": state["launches"][name],
                        "launches_dense": state["launches_dense"][name],
                        **state[key]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
