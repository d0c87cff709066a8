#!/usr/bin/env python
"""Quantify map deltas between engine configurations, per model, on the
PyTorch port.

The counterpart of ``tools/tile_parity_probe.py`` on
``digipathai_tpu_torch``, with the same variant sets, engine kwargs and
printed line.  Default comparison: inference_mode patch vs tile.
``--quant`` instead compares exact vs int8 (quantized=True) in patch mode.
Runs getSegmentation twice per model on a synthetic H&E-like slide (the
port's writer) with fixed-seed random weights and reports max|Δprob| over
the pixels both runs computed, mean|Δprob|, p99|Δprob| and Dice between
the two thresholded masks.

Usage: python tools/tile_parity_probe_torch.py [--quant] [--device DEVICE]
    [model ...]       (the device defaults to cuda)
"""
import argparse
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("DPAI_OFFLINE", "1")


def variants(quant: bool):
    if quant:
        return [("exact", {"inference_mode": "patch"}),
                ("int8", {"inference_mode": "patch", "quantized": True})]
    return [("patch", {"inference_mode": "patch"}),
            ("tile", {"inference_mode": "tile"})]


def run(model, d, slide_path, variants, device="cuda"):
    import numpy as np

    from digipathai_tpu_torch.engine.segmentation import getSegmentation
    from digipathai_tpu_torch.io.tiff_py import TiffReader

    maps = {}
    for label, kw in variants:
        base = os.path.join(d, f"{model}-{label}")
        getSegmentation(
            img_path=slide_path, patch_size=256, stride_size=128,
            batch_size=8, quick=True, model=model, mode="breast",
            tta_list=["FLIP_LEFT_RIGHT", "ROTATE_90"],
            probs_path=base + "-p.tiff", mask_path=base + "-m.tiff",
            uncertainty_path=base + "-u.tiff", supertile=1024,
            num_workers=4, data_parallel=False,
            save_float_probs=True, device=device, **kw)
        with TiffReader(base + "-p.tiff.f32.tiff") as r:
            maps[label] = np.asarray(r.read_whole(0), np.float32).squeeze()
    return maps


def stats(maps, variants) -> dict:
    """The deltas between the two variants' maps."""
    import numpy as np

    (la, p), (lb, t) = [(v[0], maps[v[0]]) for v in variants]
    # Compare ONLY where both configurations computed (probabilities are
    # written over count>0 pixels and are never exactly 0 there). Tile
    # mode covers whole supertiles while patch mode only covers strided
    # patches: that coverage difference is by design, reported
    # separately, and must not pollute the value comparison.
    cp, ct = p > 0, t > 0
    both = cp & ct
    diff = np.abs(p - t)[both]
    mp, mt = (p >= 0.3) & both, (t >= 0.3) & both
    inter = (mp & mt).sum()
    return {"a": la, "b": lb, "px": int(both.sum()),
            "only_a": int((cp & ~ct).sum()), "only_b": int((ct & ~cp).sum()),
            "max": float(diff.max()), "mean": float(diff.mean()),
            "p99": float(np.percentile(diff, 99)),
            "dice": float(2 * inter / max(mp.sum() + mt.sum(), 1))}


def compare(model, maps, variants) -> str:
    """The probe's line for one model."""
    s = stats(maps, variants)
    return (f"{model:10s} {s['a']} vs {s['b']} cmp px={s['px']} "
            f"(only-{s['a']} {s['only_a']}, only-{s['b']} {s['only_b']}): "
            f"max|dP|={s['max']:.4f} mean|dP|={s['mean']:.5f} "
            f"p99|dP|={s['p99']:.4f} Dice(mask)={s['dice']:.5f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", action="store_true",
                    help="exact vs int8 in patch mode (default: patch vs "
                         "tile)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on [cuda]")
    ap.add_argument("models", nargs="*",
                    default=["dense", "inception", "deeplabv3"])
    args = ap.parse_args(argv)

    from torch_fixtures import make_synthetic_slide

    vs = variants(args.quant)
    d = tempfile.mkdtemp(prefix="dpai_parity_torch_")
    os.environ.setdefault("DPAI_CACHE", os.path.join(d, "cache"))
    slide_path = os.path.join(d, "parity.tiff")
    try:
        make_synthetic_slide(slide_path, 2048, 2048, seed=11)
        for model in args.models:
            maps = run(model, d, slide_path, vs, args.device)
            print(compare(model, maps, vs), flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
