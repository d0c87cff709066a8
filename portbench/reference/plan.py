"""The patch plan, worked out again from the slide's coarsest level.

The reference's tissue mask (HSV saturation over its Otsu threshold, not
background by a per-channel RGB Otsu, every channel above 50), cleaned by
close(20), open(5) and a dilation by mask level (cv2's anchors: a k x k
window spans [-(k // 2), k - 1 - k // 2]), sampled every ``stride``
level-0 pixels; each kept mask pixel is a patch centred on it, clamped
into the slide, grouped by the ``supertile`` its top-left corner falls in.
Float arithmetic is float32 in the order the reference's NumPy code takes
it, so the thresholds come out to the bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import tiff


def otsu(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """skimage's ``threshold_otsu``: a histogram over [min, max], the
    between-class variance from cumulative moments, the first maximum."""
    x = x.float().reshape(-1)
    lo, hi = x.min(), x.max()
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo) / span * nbins).to(torch.int32), 0,
                      nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).float()
    centers = lo + (torch.arange(nbins, dtype=torch.float32) + 0.5) * (
        span / nbins)
    w1 = torch.cumsum(hist, 0)
    w2 = torch.cumsum(hist.flip(0), 0).flip(0)
    m1 = torch.cumsum(hist * centers, 0) / torch.clamp(w1, min=1e-12)
    m2 = (torch.cumsum((hist * centers).flip(0), 0)
          / torch.clamp(w2.flip(0), min=1e-12)).flip(0)
    between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return centers[int(torch.nonzero(between == between.max())[0, 0])]


def _window_max(m: torch.Tensor, k: int, pad: float) -> torch.Tensor:
    lo, hi = k // 2, k - 1 - k // 2
    x = F.pad(m.float()[None, None], (lo, hi, lo, hi), value=pad)
    return F.max_pool2d(x, k, stride=1)[0, 0]


def dilate(m, k):
    return _window_max(m, k, 0.0) > 0.5


def erode(m, k):
    return -_window_max(-m.float(), k, -1.0) > 0.5


def tissue(img_xyc: torch.Tensor) -> torch.Tensor:
    r, g, b = img_xyc[..., 0], img_xyc[..., 1], img_xyc[..., 2]
    x = img_xyc.float() / 255.0
    mx, mn = x.amax(-1), x.amin(-1)
    sat = torch.where(mx > 0, (mx - mn) / torch.clamp(mx, min=1e-12),
                      torch.zeros_like(mx))
    bg = ((r.float() > otsu(r)) & (g.float() > otsu(g))
          & (b.float() > otsu(b)))
    return (sat > otsu(sat)) & ~bg & (r > 50) & (g > 50) & (b > 50)


def mask(img_xyc: torch.Tensor, level: int) -> torch.Tensor:
    """Tissue, then close(20), open(5), dilate(60, 35 or 10 by level)."""
    k = {0: 60, 1: 60, 2: 60, 3: 35, 4: 10}[level]
    m = tissue(img_xyc)
    m = erode(dilate(m, 20), 20)
    m = dilate(erode(m, 5), 5)
    return dilate(m, k)


def plan(slide_path: str, patch: int, stride: int, supertile: int):
    """``{(x0, y0) supertile origin: (n, 2) int64 patch top-lefts}`` and
    the slide's (X, Y), level-0 pixels."""
    levels = tiff.read_levels(slide_path)
    X, Y = levels[0].width, levels[0].height
    n_levels = len(levels)
    down = round(X / levels[-1].width)
    img = tiff.read_level(slide_path, -1)
    m = mask(torch.from_numpy(np.ascontiguousarray(img.transpose(1, 0, 2))),
             min(n_levels - 1, 4)).numpy()
    res = round(X / m.shape[0])
    step = max(1, stride // down)
    strided = np.zeros_like(m)
    strided[::step, ::step] = m[::step, ::step]
    xi, yi = np.nonzero(strided)
    xs = np.clip(xi.astype(np.int64) * res - patch // 2, 0, X - patch)
    ys = np.clip(yi.astype(np.int64) * res - patch // 2, 0, Y - patch)
    groups = {}
    for x, y in zip(xs.tolist(), ys.tolist()):
        key = (x // supertile * supertile, y // supertile * supertile)
        groups.setdefault(key, []).append((x, y))
    return {k: np.asarray(v, np.int64) for k, v in sorted(groups.items())}, (
        X, Y)
