#!/usr/bin/env python
"""Generate a synthetic H&E-like demo slide (+ ground truth) to try the
PyTorch port without real data:

    python examples/make_demo_slide_torch.py demo/ --size 4096 3072
    digipathai-torch -s demo/      # then open http://127.0.0.1:8080

The counterpart of ``examples/make_demo_slide.py``: the same image
(``tests/fixtures.py::render_he_like``, through
``tools/torch_fixtures.py``) written with the port's pyramid writer, so
with the same TIFF backend both scripts write the same bytes.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--size", nargs=2, type=int, default=[2048, 1536],
                    metavar=("W", "H"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from digipathai_tpu_torch.io.backend import write_pyramid
    from torch_fixtures import load as fixtures

    os.makedirs(args.out_dir, exist_ok=True)
    w, h = args.size
    img, tissue, lesion = fixtures().render_he_like(w, h, args.seed)
    slide = os.path.join(args.out_dir, "demo-slide.tiff")
    gt = os.path.join(args.out_dir, "demo-slide-gt.tiff")
    write_pyramid(slide, img, compression="jpeg", quality=92, mpp=0.5,
                  description="DigiPathAI-TPU synthetic demo")
    write_pyramid(gt, (lesion * 255).astype(np.uint8), compression="deflate")
    print(slide)
    print(gt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
