#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (digipathai_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - card name and power limit (nvidia-smi), torch/CUDA versions;
2. build   - compile every CUDA kernel of the main path from csrc/;
3. kernels - each kernel against its plain PyTorch version at the main
             path's shapes (N=32), f32 (TF32 off) and bf16, with timings;
4. model   - a full DenseNet121-U-Net forward, batch 32 at 256^2 in bf16,
             through the kernel and through the plain version;
5. engine  - getSegmentation (patch mode, dense, quick) on a synthetic
             slide: three readable TIFFs, a mask of shape (X, Y), 68 kernel
             launches per batch; then the oracle model against the slide's
             known lesion;
6. server  - the WSGI app in process: GET /, the .dzi, POST /segment,
             poll to Done, then the mask's .dzi and one mask tile.

Prints a JSON line of per-kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero before printing any result.
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


def log(msg):
    print(msg, flush=True)


def make_synthetic_slide(*args, **kw):
    """``tests/fixtures.py::make_synthetic_slide``, loaded by path: another
    installed package may own the top-level name ``tests``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures.py")
    spec = importlib.util.spec_from_file_location("dpai_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_synthetic_slide(*args, **kw)


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
    path = _build.build("conv_fused")
    _build.load("conv_fused")
    log(f"[build] conv_fused.cu -> {path.name} in {time.time() - t:.2f} s")
    for line in _build.build_logs.get("conv_fused", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


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

    from digipathai_tpu_torch.ops.conv_fused import (fused_conv3x3,
                                                     fused_conv3x3_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst, ms, plain_ms = 0.0, 0.0, 0.0
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
                if name != "ragged":
                    ms += t_k
                    plain_ms += t_p
            del x, k, kw, got, ref
    torch.cuda.empty_cache()
    state["conv"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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


def phase_engine(state):
    import torch

    import digipathai_tpu_torch as dpt
    from digipathai_tpu_torch.engine.planner import plan_patches
    from digipathai_tpu_torch.ops import conv_fused

    d = os.path.join(state["tmp"], "engine")
    os.makedirs(d)
    path = os.path.join(d, "smoke-slide.tiff")
    t = time.time()
    meta = make_synthetic_slide(path, width=SLIDE[0], height=SLIDE[1], seed=0)
    log(f"[engine] synthetic slide {SLIDE[0]}x{SLIDE[1]} written in "
        f"{time.time() - t:.1f} s")
    with dpt.Slide(path) as s:
        plan = plan_patches(s, patch=PATCH, stride=128, batch=BATCH)

    def run(model, tag):
        outs = {k: os.path.join(d, f"{tag}-{k}.tiff")
                for k in ("probs", "mask", "uncertainty")}
        status, batches = {}, []
        t0 = time.time()
        mask = dpt.getSegmentation(
            path, probs_path=outs["probs"], mask_path=outs["mask"],
            uncertainty_path=outs["uncertainty"], status=status, quick=True,
            model=model, mode="colon",
            progress_cb=lambda done, total: batches.append(done))
        torch.cuda.synchronize()
        wall = time.time() - t0
        if mask.shape != SLIDE or not set(mask.ravel()[::997]) <= {0, 255}:
            raise AssertionError(f"{model}: bad mask {mask.shape}")
        for p in outs.values():
            with dpt.Slide(p) as s:
                if s.dimensions != SLIDE:
                    raise AssertionError(f"{p}: dimensions {s.dimensions}")
        return mask, status, len(batches), wall

    conv_fused.fused_conv3x3.launches = 0  # the main path starts here
    mask, status, nb, wall = run("dense", "dense")
    launches = conv_fused.fused_conv3x3.launches
    state["launches"] = launches
    if nb != plan.total_batches or launches != 68 * nb:
        raise AssertionError(f"{launches} kernel launches for {nb} batches "
                             f"(plan: {plan.total_batches}); want 68 each")
    if status.get("weights") != "random":
        raise AssertionError(f"weights status {status.get('weights')!r}")
    log(f"[engine] dense patch mode: {plan.total_patches} patches, {nb} "
        f"batches of {BATCH}, {len(plan.groups)} supertiles, {launches} "
        f"kernel launches; wall {wall:.2f} s = "
        f"{plan.total_patches / wall:.1f} patches/s; stages "
        f"{status['timings']} | {state['smi']}")

    # the oracle model's segmentation is known: the slide's lesion
    mask, _, _, wall = run("oracle", "oracle")
    got = mask.T > 0
    lesion = meta["lesion_mask"]
    iou = (got & lesion).sum() / max((got | lesion).sum(), 1)
    log(f"[engine] oracle: lesion IoU {iou:.3f} (bound 0.7), wall {wall:.2f} s")
    if iou <= 0.7:
        raise AssertionError(f"oracle lesion IoU {iou}")


def phase_server(state):
    import threading
    import urllib.request

    from digipathai_tpu_torch.ops import conv_fused
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
        n0 = conv_fused.fused_conv3x3.launches
        get("/segment", data=b"tissuetype=Colon")
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
        log(f"[server] /segment Done in {time.time() - t0:.1f} s with "
            f"{conv_fused.fused_conv3x3.launches - n0} kernel launches; "
            f"mask .dzi and tile served ({len(tile)} bytes)")
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
    if "jax" in sys.modules or "flax" in sys.modules:
        raise AssertionError("the port loaded jax/flax")
    c = state["conv"]
    print(json.dumps({"kernels": [{
        "name": "fused_conv3x3", "route": "cuda",
        "source": "digipathai_tpu_torch/csrc/conv_fused.cu",
        "replaces": "digipathai_tpu/ops/pallas/conv_fused.py:119",
        "launches": state["launches"], "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "plain_ms": c["plain_ms"]}]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
