#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (digipathai_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - card name and power limit (nvidia-smi), torch/CUDA versions;
2. build   - compile every CUDA kernel from csrc/, one nvcc per source, all
             started together;
3. kernels - each kernel against its plain PyTorch version at the main
             paths' shapes, with timings: fused_conv3x3 at N=32 in f32 (TF32
             off) and bf16; bilateral_message at the CRF's 1024^2 and
             1024x512 grids, ragged, small, sentinel-padded and L=3 cases;
4. model   - a full DenseNet121-U-Net forward, batch 32 at 256^2 in bf16,
             through the kernel and through the plain version;
5. engine  - getSegmentation (patch mode, dense, quick) on a synthetic
             slide, without and with crf=True: three readable TIFFs, a mask
             of shape (X, Y), 68 conv launches per batch and, with the CRF,
             n_iters bilateral launches per tissue supertile; then the
             oracle model against the slide's known lesion, without and with
             the CRF; then the oracle CRF run on the card against the CPU;
6. server  - the WSGI app in process: GET /, the .dzi, POST /segment with
             crf=1, poll to Done, then the mask's .dzi and one mask tile.

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
# bf16 bound of kernel vs plain: the plain version rounds the conv output to
# bf16 before its affine (2^-8 relative) and rounds again after it; the
# kernel rounds once.  Two roundings of 2^-8 of the output scale, doubled.
BF16_REL = 2.0 ** -6
# f32 bound (TF32 off on both sides): only the summation order differs.
F32_REL = 2e-4
CONV_SHAPES = [  # (name, N, H, W, C, F, pre-affine)
    ("dense_layer", 32, 64, 64, 128, 32, True),
    ("decoder_widest", 32, 16, 16, 1344, 320, False),
    ("decoder_largest", 32, 256, 256, 96, 64, False),
    ("ragged", 3, 13, 29, 5, 7, True),
]
# bilateral message, kernel vs plain (tests/test_pallas.py's bound): only
# the summation order and exp's rounding differ
BIL_BOUND = 2e-5
BIL_CASES = [  # (name, H, W, L, r, sigma_xy, sigma_rgb, sentinel)
    # the engine's grids: 4096^2 and 4096x2048 buckets downsampled 4x
    ("crf_4096", 1024, 1024, 2, 10, 12.5, 20.0, False),
    ("crf_4096x2048", 1024, 512, 2, 10, 12.5, 20.0, False),
    ("ragged", 70, 90, 2, 10, 12.5, 20.0, False),
    ("small", 48, 48, 2, 3, 12.5, 20.0, False),
    ("sentinel", 256, 200, 2, 10, 12.5, 20.0, True),
    ("labels3", 100, 120, 3, 10, 12.5, 20.0, False),
]
# the oracle CRF run, card vs CPU, f32: the bilateral kernel and the plain
# message differ by ~1e-6 per iteration, cuDNN and the CPU conv likewise
CRF_DEVICE_BOUND = 1e-4
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
        log(f"[build] {name}.cu -> {path.name}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(paths)} kernels in {time.time() - t:.2f} s")


def conv_inputs(n, h, w, c, f, pre, dtype, seed):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    k = torch.randn(3, 3, c, f, generator=g) / (9 * c) ** 0.5
    kw = {}
    if pre:
        kw["pre_mul"] = torch.rand(c, generator=g) + 0.5
        kw["pre_add"] = torch.rand(c, generator=g) * 0.4 + 0.1  # halo-leak case
        kw["relu"] = False
    else:
        kw["bias"] = torch.randn(f, generator=g) * 0.1
        kw["mul"] = torch.rand(f, generator=g) + 0.5
        kw["add"] = torch.randn(f, generator=g) * 0.1
    kw = {k_: (v.cuda() if isinstance(v, torch.Tensor) else v)
          for k_, v in kw.items()}
    return x.cuda().to(dtype), k.cuda(), kw


def phase_kernels(state):
    import torch

    # the f32 conv rows compare against cuDNN and cuBLAS in full f32; the
    # switches go back to the user's settings for the phases that follow
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernels_conv(state)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    kernels_bilateral(state)


def kernels_conv(state):
    import torch
    import torch.nn.functional as F

    from digipathai_tpu_torch.ops.conv_fused import (fused_conv3x3,
                                                     fused_conv3x3_plain)

    worst, ms, plain_ms, lib_ms, bound_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    bound_by = {}
    for name, n, h, w, c, f, pre in CONV_SHAPES:
        for dtype, rel in ((torch.float32, F32_REL), (torch.bfloat16, BF16_REL)):
            x, k, kw = conv_inputs(n, h, w, c, f, pre, dtype, seed=c + f)
            got = fused_conv3x3(x, k, **kw)
            ref = fused_conv3x3_plain(x, k, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            ok = err <= rel * scale
            t_k = time_ms(lambda: fused_conv3x3(x, k, **kw))
            t_p = time_ms(lambda: fused_conv3x3_plain(x, k, **kw))
            flop = 2.0 * n * h * w * 9 * c * f
            log(f"[kernels] {name} ({n},{h},{w},{c})->{f} "
                f"{str(dtype).split('.')[-1]}: max|d|={err:.3e} "
                f"bound={rel * scale:.3e} kernel {t_k:.3f} ms "
                f"({flop / t_k / 1e9:.1f} TFLOP/s) plain {t_p:.3f} ms "
                f"({flop / t_p / 1e9:.1f} TFLOP/s)")
            if not ok:
                raise AssertionError(f"fused_conv3x3 {name} {dtype}: max|d| "
                                     f"{err} > {rel * scale}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                # the library yardstick: cuDNN's conv alone (no affine, no
                # pre-activation), channels-last bf16 on the same inputs
                xc = x.permute(0, 3, 1, 2)
                kc = k.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                t_l = time_ms(lambda: F.conv2d(xc, kc, padding=1))
                b_ms, b_by = bound(flop, 2 * (x.numel() + k.numel()
                                              + n * h * w * f), "bf16")
                log(f"[kernels]   bf16 bound {b_ms:.4f} ms ({b_by}); "
                    f"cuDNN conv2d alone {t_l:.3f} ms")
                if name != "ragged":
                    ms += t_k
                    plain_ms += t_p
                    lib_ms += t_l
                    bound_ms += b_ms
                    bound_by[b_by] = bound_by.get(b_by, 0.0) + b_ms
            del x, k, kw, got, ref
    torch.cuda.empty_cache()
    state["conv"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": max(bound_by, key=bound_by.get),
                     "library_ms": lib_ms}


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
    import torch

    from digipathai_tpu_torch.ops.bilateral import bilateral_message
    from digipathai_tpu_torch.ops.crf import _PAD_COLOR, _bilateral_message

    worst, ms, plain_ms, bound_ms = 0.0, 0.0, 0.0, 0.0
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
        got = bilateral_message(q, img, sxy, srgb, r)
        ref = _bilateral_message(q, img, sxy, srgb, r)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not torch.isfinite(got).all() or not err <= BIL_BOUND:
            raise AssertionError(f"bilateral_message {name}: max|d| {err} "
                                 f"(bound {BIL_BOUND}) or non-finite")
        t_k = time_ms(lambda: bilateral_message(q, img, sxy, srgb, r))
        t_p = time_ms(lambda: _bilateral_message(q, img, sxy, srgb, r),
                      reps=3, warmup=1)
        flop, nbytes = bilateral_work(h, w, n_labels, r)
        b_ms, b_by = bound(flop, nbytes, "f32")
        log(f"[kernels] bilateral {name} ({h},{w},{n_labels}) r={r}: "
            f"max|d|={err:.3e} (bound {BIL_BOUND}) kernel {t_k:.3f} ms plain "
            f"{t_p:.3f} ms bound {b_ms:.4f} ms ({b_by}, {flop / 1e9:.2f} "
            f"GFLOP) | {state['smi']}")
        worst = max(worst, err)
        if name.startswith("crf_"):
            ms += t_k
            plain_ms += t_p
            bound_ms += b_ms
            bound_by[b_by] = bound_by.get(b_by, 0.0) + b_ms
        del img, q, got, ref
    torch.cuda.empty_cache()
    # no single PyTorch call computes this message: library_ms is null
    state["bilateral"] = {"max_abs_err": worst, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": max(bound_by, key=bound_by.get),
                          "library_ms": None}


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
    del m, u8, x, p, q, d
    torch.cuda.empty_cache()


def reset_launches():
    """Set every kernel's launch count to 0 (a main path starts here)."""
    from digipathai_tpu_torch.ops import bilateral, conv_fused

    conv_fused.fused_conv3x3.launches = 0
    bilateral.bilateral_message.launches = 0


def read_launches() -> dict:
    from digipathai_tpu_torch.ops import bilateral, conv_fused

    return {"fused_conv3x3": conv_fused.fused_conv3x3.launches,
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

    def run(model, tag, slide=path, dims=SLIDE, **kw):
        outs = {k: os.path.join(d, f"{tag}-{k}.tiff")
                for k in ("probs", "mask", "uncertainty")}
        status, batches = {}, []
        t0 = time.time()
        mask = dpt.getSegmentation(
            slide, probs_path=outs["probs"], mask_path=outs["mask"],
            uncertainty_path=outs["uncertainty"], status=status, quick=True,
            model=model, mode="colon",
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
    state["launches"] = {}
    walls = {}
    for crf in (False, True):
        reset_launches()
        _, status, nb, wall = run("dense", f"dense-crf{int(crf)}", crf=crf)
        got = read_launches()
        want = {"fused_conv3x3": 68 * nb,
                "bilateral_message": want_bil if crf else 0}
        if nb != plan.total_batches or got != want:
            raise AssertionError(f"crf={crf}: launches {got}, want {want} "
                                 f"({nb} batches; plan {plan.total_batches})")
        if status.get("weights") != "random":
            raise AssertionError(f"weights status {status.get('weights')!r}")
        if crf:
            state["launches"]["bilateral_message"] = got["bilateral_message"]
        else:
            state["launches"]["fused_conv3x3"] = got["fused_conv3x3"]
        walls[crf] = wall
        log(f"[engine] dense patch mode crf={crf}: {plan.total_patches} "
            f"patches, {nb} batches of {BATCH}, {len(plan.groups)} "
            f"supertiles, launches {got}; wall {wall:.2f} s = "
            f"{plan.total_patches / wall:.1f} patches/s; stages "
            f"{status['timings']} | {state['smi']}")
    log(f"[engine] CRF post-pass: {want_bil // n_iters} tissue supertiles, "
        f"{state['launches']['bilateral_message']} bilateral launches; "
        f"e2e {walls[False]:.2f} s without crf, {walls[True]:.2f} s with "
        f"| {state['smi']}")

    # the oracle model's segmentation is known: the slide's lesion
    lesion = meta["lesion_mask"]
    for crf, floor in ((False, 0.7), (True, 0.6)):
        mask, status, _, wall = run("oracle", f"oracle-crf{int(crf)}",
                                    crf=crf)
        got = mask.T > 0
        iou = (got & lesion).sum() / max((got | lesion).sum(), 1)
        log(f"[engine] oracle crf={crf}: lesion IoU {iou:.3f} (bound "
            f"{floor}), wall {wall:.2f} s, stages {status['timings']}")
        if iou <= floor:
            raise AssertionError(f"oracle crf={crf} lesion IoU {iou}")

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


def phase_server(state):
    import threading
    import urllib.request

    from digipathai_tpu_torch.server import ServerConfig, create_app, serve

    d = os.path.join(state["tmp"], "serve")
    os.makedirs(d)
    make_synthetic_slide(os.path.join(d, "colon-smoke.tiff"), 2048, 1536,
                         seed=2)
    httpd = serve(create_app(ServerConfig(slide_dir=d, viewer_only=False)),
                  host="127.0.0.1", port=0, quiet=True)
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
        n0 = read_launches()
        get("/segment", data=b"tissuetype=Colon&crf=1")
        t0 = time.time()
        while True:
            st = json.loads(get("/check_segment_status"))
            if st["status"] == "Done":
                break
            if st["status"] == "Error" or time.time() - t0 > 600:
                raise AssertionError(f"/segment: {st}")
            time.sleep(0.5)
        dzi = get("/colon-smoke-dgai-mask.tiff.dzi")
        tile = get("/colon-smoke-dgai-mask.tiff_files/8/0_0.jpeg")
        if b'Width="2048"' not in dzi or tile[:2] != b"\xff\xd8":
            raise AssertionError("mask overlay not served")
        moved = {k: v - n0[k] for k, v in read_launches().items()}
        if not all(moved.values()):
            raise AssertionError(f"/segment crf=1 launched {moved}")
        log(f"[server] /segment crf=1 Done in {time.time() - t0:.1f} s with "
            f"launches {moved}; mask .dzi and tile served ({len(tile)} "
            f"bytes)")
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
                      phase_engine, phase_server):
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
            ("bilateral_message", "bilateral", "bilateral.cu",
             "digipathai_tpu/ops/pallas/bilateral.py:104")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"digipathai_tpu_torch/csrc/{src}",
                        "replaces": tpu,
                        "launches": state["launches"][name],
                        **state[key]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
