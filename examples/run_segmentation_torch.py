#!/usr/bin/env python
"""Drive the PyTorch port's engine across models and score it against
ground truth (``examples/run_segmentation.py``'s twin on
``digipathai_tpu_torch``).

Run ``getSegmentation`` for each requested model (or the full ensemble),
read the written mask back at its coarsest level, score it against a
``-gt`` ground-truth slide when there is one (the Dice score of
``utils/metrics.py::dice``, which the reference calls IoU), and save a
comparison figure (``utils/viz.py``; best effort, needs matplotlib).

Example:
    python examples/run_segmentation_torch.py slide.tiff \\
        --models dense ensemble --mode breast --out results/

``--device`` is a torch device (``cuda``, the default, runs on every
visible card with ``data_parallel=True``; ``cpu`` on the CPU).  Besides
the reference's models, ``tiny`` and ``oracle`` (the registry's test
models) run too.
"""

from __future__ import annotations

import argparse
import os
import time

MODELS = ["dense", "inception", "deeplabv3", "tiny", "oracle", "ensemble",
          "epistemic"]


def evaluate(mask_path: str, gt_path: str) -> float:
    from digipathai_tpu_torch.io.slide import Slide
    from digipathai_tpu_torch.utils.metrics import dice

    with Slide(mask_path) as sm:
        lvl = sm.level_count - 1
        pred = sm.read_level(lvl)[:, :, 0] > 127
    with Slide(gt_path) as sg:
        lvl = sg.get_best_level_for_downsample(
            sg.dimensions[0] / pred.shape[1])
        gt = sg.read_level(lvl)[:, :, 0] > 0
    h = min(pred.shape[0], gt.shape[0])
    w = min(pred.shape[1], gt.shape[1])
    return dice(pred[:h, :w], gt[:h, :w])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("slide")
    ap.add_argument("--models", nargs="+", default=["ensemble"],
                    choices=MODELS)
    ap.add_argument("--mode", default="colon",
                    choices=["colon", "liver", "breast"])
    ap.add_argument("--out", default="results")
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--stride", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tta", nargs="*", default=None,
                    help="e.g. FLIP_LEFT_RIGHT ROTATE_90")
    ap.add_argument("--crf", action="store_true")
    ap.add_argument("--gt", default=None,
                    help="ground-truth slide (defaults to <stem>-gt.<ext>)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card, the default) or cpu")
    args = ap.parse_args(argv)

    from digipathai_tpu_torch import getSegmentation

    os.makedirs(args.out, exist_ok=True)
    stem, ext = os.path.splitext(os.path.basename(args.slide))
    gt = args.gt or os.path.join(os.path.dirname(args.slide), f"{stem}-gt{ext}")

    rows = []
    for model in args.models:
        # "epistemic" = the full ensemble with NO TTA: the uncertainty map
        # then holds the inter-model (epistemic) variance only
        quick = model not in ("ensemble", "epistemic")
        tta = [] if model == "epistemic" else args.tta
        tag = os.path.join(args.out, f"{stem}-{model}")
        t0 = time.time()
        getSegmentation(
            img_path=args.slide, patch_size=args.patch,
            stride_size=args.stride, batch_size=args.batch,
            tta_list=tta, crf=args.crf, quick=quick,
            model=model if quick else "dense", mode=args.mode,
            probs_path=f"{tag}-probs.tiff",
            mask_path=f"{tag}-dgai-mask.tiff",
            uncertainty_path=f"{tag}-dgai-uncertainty.tiff",
            data_parallel=True, device=args.device)
        secs = time.time() - t0
        iou = evaluate(f"{tag}-dgai-mask.tiff", gt) if os.path.exists(gt) else None
        rows.append((model, secs, iou))
        print(f"{model}: {secs:.1f}s"
              + (f", IoU={iou:.4f}" if iou is not None else ""))

    try:
        plot(args.slide, args.out, stem, [m for m, _, _ in rows])
    except Exception as e:  # noqa: BLE001 - the figure is best effort
        print(f"(no comparison figure: {e})")
    return 0


def plot(slide_path: str, out: str, stem: str, models):
    """The slide beside each model's probability map, both at their
    coarsest level, side by side in one PNG."""
    from digipathai_tpu_torch.io.slide import Slide
    from digipathai_tpu_torch.utils.viz import imsave

    with Slide(slide_path) as s:
        images = [s.read_level(s.level_count - 1)]
    for model in models:
        with Slide(os.path.join(out, f"{stem}-{model}-probs.tiff")) as sp:
            images.append(sp.read_level(sp.level_count - 1)[:, :, 0])
    path = os.path.join(out, f"{stem}-comparison.png")
    imsave(path, *images, titles=["slide", *models])
    print(f"wrote {path}")


if __name__ == "__main__":
    raise SystemExit(main())
