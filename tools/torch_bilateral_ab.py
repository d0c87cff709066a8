#!/usr/bin/env python3
"""Time the bilateral-message kernel against an earlier version of it on one
NVIDIA GPU, kernel-only, in one process.

    python3 tools/torch_bilateral_ab.py --old path/to/old/bilateral.cu

``--old`` is an earlier ``csrc/bilateral.cu`` with the entry point
``dpai_bilateral_message(q, img, out, h, w, L, l0, nl, r, inv2_xy, inv2_c,
stream)`` (one thread per pixel; ``inv2_* = 1 / 2 sigma^2``).  It is built
with the flags of ``digipathai_tpu_torch/_build.py`` into a temporary
directory.  At the CRF's grids (``chip_smoke.BIL_TIMED``) the script holds
the old kernel and the current one (``ops/bilateral.py``) to the plain
version, then times, in the order old, current, current, old, 20
back-to-back launches captured in one CUDA graph
(``chip_smoke.graph_ms``).  The current kernel is also timed under each
other compiled tile that takes the shape, unrolled where that tile
compiles the radius and with the radius at run time.
Prints one line per shape and kernel, the card's name and power limit, and
a JSON line of the medians.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from digipathai_tpu_torch import _build  # noqa: E402
from digipathai_tpu_torch.ops import bilateral as bil  # noqa: E402
from digipathai_tpu_torch.ops.crf import _bilateral_message  # noqa: E402


def load_old(src: str):
    """Build ``src`` with nvcc into a temporary directory and load it."""
    d = tempfile.mkdtemp(prefix="dpai_bilateral_old_")
    try:
        so = os.path.join(d, "libbilateral_old.so")
        r = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-o", so, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
        for line in (r.stdout + r.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[old build] {line.strip()}", flush=True)
        lib = ctypes.CDLL(so)
    finally:
        shutil.rmtree(d, ignore_errors=True)  # the loaded library stays mapped
    f = lib.dpai_bilateral_message
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="an earlier bilateral.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bilateral_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = smoke.smi_line()
    print(f"[device] {smi}", flush=True)
    old = load_old(args.old)
    lib = _build.load("bilateral")
    for line in _build.build_logs.get("bilateral", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for name, h, w, n_labels, r, sxy, srgb, _ in smoke.BIL_CASES:
        if name not in smoke.BIL_TIMED:
            continue
        g = torch.Generator().manual_seed(h * w + r)
        img = (torch.rand(h, w, 3, generator=g) * 255).cuda()
        q = torch.rand(h, w, n_labels, generator=g).cuda()
        out = torch.empty_like(q)
        inv2_xy, inv2_c = 0.5 / (sxy * sxy), 0.5 / (srgb * srgb)
        a, cs = bil.kernel_constants(sxy, srgb)

        def run_old():
            for l0 in range(0, n_labels, 4):
                nl = min(4, n_labels - l0)
                rc = old(q.data_ptr(), img.data_ptr(), out.data_ptr(), h, w,
                         n_labels, l0, nl, r, inv2_xy, inv2_c, stream())
                assert rc == 0, f"old kernel: CUDA error {rc}"
            return out

        def run_new(plan):
            def go():
                rc = lib.dpai_bilateral_message(
                    q.data_ptr(), img.data_ptr(), out.data_ptr(), h, w,
                    n_labels, 0, n_labels, r, a, cs, plan.as_c(), stream())
                assert rc == 0, f"kernel {plan}: CUDA error {rc}"
                return out
            return go

        plan = bil.plan_bilateral(h, w, n_labels, r)
        variants = {f"current K={plan.k} unrolled r={plan.spec}":
                    run_new(plan)}
        for k, warps in bil.TILES:
            if bil.halo_bytes(k * warps, n_labels, r) > bil.SMEM_ONE_BLOCK:
                continue
            unrolled = (k, warps) in bil.SPECIALISED.get(r, ())
            for spec in ((r, 0) if unrolled else (0,)):
                if (k, warps, spec) != (plan.k, plan.warps, plan.spec):
                    variants[f"K={k} unrolled r={spec}"] = run_new(
                        plan._replace(k=k, warps=warps, spec=spec))
        ref = _bilateral_message(q, img, sxy, srgb, r)
        for label, fn in (("old", run_old), *variants.items()):
            err = (fn() - ref).abs().max().item()
            assert err <= smoke.BIL_BOUND, f"{name} {label}: max|d| {err}"
        times = {k: [] for k in ("old", *variants)}
        for label in ("old", *variants, *reversed(variants), "old"):
            fn = run_old if label == "old" else variants[label]
            times[label].append(smoke.graph_ms(fn))
        flop, nbytes = smoke.bilateral_work(h, w, n_labels, r)
        b_ms, b_by = smoke.bound(flop, nbytes, "f32")
        med = {k: statistics.median(v) for k, v in times.items()}
        for label, t in med.items():
            print(f"[ab] {name} ({h},{w},{n_labels}) r={r} {label}: kernel "
                  f"{t:.4f} ms ({', '.join(f'{x:.4f}' for x in times[label])})"
                  f", bound {b_ms:.4f} ms ({b_by}), old/this "
                  f"{med['old'] / t:.2f} | {smi}", flush=True)
        result[name] = {"bound_ms": b_ms, **med}
        del img, q, out, ref
    print(json.dumps(result))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
