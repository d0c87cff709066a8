"""Convert flat images to viewer-ready tiled pyramidal TIFFs.

Parity target: ``create_pyramidal_img``
(``reference DigiPathAI/helpers/convert_to_pyramidal.py:7-39``), which shells
out to ImageMagick ``convert ... ptif:``.  Here the conversion is in-process
through the first-party pyramid writer (native C++ when built).

CLI: ``python -m digipathai_tpu_torch.io.convert INPUT OUTPUT [--compression ...]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def create_pyramidal_img(img_path: str, output_path: str,
                         compression: str = "jpeg", quality: int = 90,
                         tile: int = 256, mpp=None) -> str:
    """Convert ``img_path`` (any PIL-readable image or flat TIFF) into a
    tiled pyramidal TIFF at ``output_path`` (a directory or file path)."""
    from PIL import Image

    from .backend import write_pyramid

    Image.MAX_IMAGE_PIXELS = None  # gigapixel inputs are the point
    if os.path.isdir(output_path):
        base = os.path.splitext(os.path.basename(img_path))[0]
        output_path = os.path.join(output_path, base + ".tiff")
    with Image.open(img_path) as im:
        if im.mode not in ("RGB", "L"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    write_pyramid(output_path, arr, tile=tile, compression=compression,
                  quality=quality, mpp=mpp)
    return output_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert an image to a tiled pyramidal TIFF")
    ap.add_argument("input")
    ap.add_argument("output", help="output file or directory")
    ap.add_argument("--compression", default="jpeg",
                    choices=["jpeg", "deflate", "raw"])
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--mpp", type=float, default=None,
                    help="microns per pixel metadata")
    args = ap.parse_args(argv)
    out = create_pyramidal_img(args.input, args.output,
                               compression=args.compression,
                               quality=args.quality, tile=args.tile,
                               mpp=args.mpp)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
