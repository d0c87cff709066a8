"""Deep Zoom tiling over a Slide.

First-party replacement for ``openslide.deepzoom.DeepZoomGenerator`` as used
by the reference tile server (``reference DigiPathAI/main_server.py:55,234``):
same protocol (``.dzi`` descriptor + ``_files/<level>/<col>_<row>.<fmt>``),
same defaults (tile 254, overlap 1).
"""

from __future__ import annotations

import math
from io import BytesIO
from typing import Tuple

import numpy as np
from PIL import Image


class DeepZoomGenerator:
    def __init__(self, slide, tile_size: int = 254, overlap: int = 1,
                 limit_bounds: bool = True):
        self.slide = slide
        self.tile_size = int(tile_size)
        self.overlap = int(overlap)
        # limit_bounds crops the pyramid to the slide's non-empty bounds when
        # the format records them (OpenSlide parity, reference
        # main_server.py:94-104).  First-party TIFFs expose bounds=None, so
        # the full image is used; scanner formats (e.g. MRXS) set
        # ``Slide.bounds`` = (x, y, w, h) in level-0 pixels.
        bounds = getattr(slide, "bounds", None) if limit_bounds else None
        self._origin = (int(bounds[0]), int(bounds[1])) if bounds else (0, 0)
        w, h = (int(bounds[2]), int(bounds[3])) if bounds else slide.dimensions
        self._l0_dims = (w, h)
        self._dims = [(w, h)]
        while max(self._dims[-1]) > 1:
            w = max(1, (w + 1) // 2)
            h = max(1, (h + 1) // 2)
            self._dims.append((w, h))
        self._dims.reverse()  # level 0 = 1x1 ... level_count-1 = full res
        self.mpp = slide.mpp or 0

    @property
    def level_count(self) -> int:
        return len(self._dims)

    @property
    def level_dimensions(self):
        return tuple(self._dims)

    @property
    def level_tiles(self):
        t = self.tile_size
        return tuple((math.ceil(w / t), math.ceil(h / t)) for w, h in self._dims)

    def get_dzi(self, fmt: str = "jpeg") -> str:
        w, h = self._l0_dims
        return (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<Image xmlns="http://schemas.microsoft.com/deepzoom/2008" '
            f'Format="{fmt}" Overlap="{self.overlap}" TileSize="{self.tile_size}">'
            f'<Size Width="{w}" Height="{h}"/></Image>'
        )

    def get_tile(self, level: int, address: Tuple[int, int]) -> Image.Image:
        if not (0 <= level < self.level_count):
            raise ValueError(f"invalid Deep Zoom level {level}")
        col, row = address
        cols, rows = self.level_tiles[level]
        if not (0 <= col < cols and 0 <= row < rows):
            raise ValueError(f"invalid tile address {address} at level {level}")

        lw, lh = self._dims[level]
        t, o = self.tile_size, self.overlap
        x0 = col * t - (o if col > 0 else 0)
        y0 = row * t - (o if row > 0 else 0)
        x1 = min(col * t + t + (o if col + 1 < cols else 0), lw)
        y1 = min(row * t + t + (o if row + 1 < rows else 0), lh)
        w, h = x1 - x0, y1 - y0

        scale = 2 ** (self.level_count - 1 - level)  # level-0 px per dz px
        sl = self.slide.get_best_level_for_downsample(scale)
        ds = self.slide.level_downsamples[sl]
        # region in the chosen slide level's pixels
        rw = max(1, int(round(w * scale / ds)))
        rh = max(1, int(round(h * scale / ds)))
        arr = self.slide.read_region(
            (self._origin[0] + int(x0 * scale),
             self._origin[1] + int(y0 * scale)), sl, (rw, rh))
        img = Image.fromarray(np.asarray(arr))
        if (rw, rh) != (w, h):
            img = img.resize((w, h), Image.BILINEAR)
        return img

    def tile_bytes(self, level: int, address, fmt: str = "jpeg",
                   quality: int = 75) -> bytes:
        buf = BytesIO()
        self.get_tile(level, address).save(buf, fmt, quality=quality)
        return buf.getvalue()
