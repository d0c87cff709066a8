"""Binary morphology and tissue masks on tensors (``digipathai_tpu/ops/morphology.py``).

cv2 anchor semantics: a k x k rectangular window spans offsets
[-(k//2), k - 1 - k//2], asymmetric for even k, so the pad is explicit and
``max_pool2d`` runs with padding 0 (its own padding is symmetric).  Borders
pad with the identity value, as cv2's default BORDER_CONSTANT does: 0 for
dilate, 1 for erode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .color import rgb_to_hsv_saturation
from .otsu import otsu_threshold


def _pool_max(m: torch.Tensor, k: int, pad_value: float) -> torch.Tensor:
    lo, hi = k // 2, k - 1 - k // 2
    x = F.pad(m.float()[None, None], (lo, hi, lo, hi), value=pad_value)
    return F.max_pool2d(x, k, stride=1)[0, 0]


def dilate(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary dilation with a k x k rectangular kernel (cv2.dilate parity)."""
    return _pool_max(mask, k, 0.0) > 0.5


def erode(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary erosion with a k x k rectangular kernel (cv2.erode parity)."""
    return -_pool_max(-mask.float(), k, -1.0) > 0.5


def close(mask: torch.Tensor, k: int) -> torch.Tensor:
    return erode(dilate(mask, k), k)


def open_(mask: torch.Tensor, k: int) -> torch.Tensor:
    return dilate(erode(mask, k), k)


def _dilate_kernel_for_level(level: int) -> int:
    if level <= 2:
        return 60
    if level == 3:
        return 35
    if level == 4:
        return 10
    raise ValueError(f"no dilation kernel fixed for level {level}")


def morpho_process_mask(mask: torch.Tensor, level: int) -> torch.Tensor:
    """close(20) -> open(5) -> dilate(60|35|10) by mask level."""
    k = _dilate_kernel_for_level(level)
    return dilate(open_(close(mask, 20), 5), k)


def tissue_mask(img_xyc_u8: torch.Tensor) -> torch.Tensor:
    """HSV-saturation and per-channel RGB Otsu tissue mask of an (X, Y, 3)
    uint8 image."""
    img = img_xyc_u8
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    sat = rgb_to_hsv_saturation(img)
    bg = ((r.float() > otsu_threshold(r)) & (g.float() > otsu_threshold(g))
          & (b.float() > otsu_threshold(b)))
    tissue_s = sat > otsu_threshold(sat)
    return tissue_s & ~bg & (r > 50) & (g > 50) & (b > 50)


def plan_mask(img_xyc_u8: torch.Tensor, level: int) -> torch.Tensor:
    """Tissue mask + morphology: what the planner thresholds patches on."""
    return morpho_process_mask(tissue_mask(img_xyc_u8), level)


def tissue_mask_patch(patch_rgb: torch.Tensor) -> torch.Tensor:
    """Patch-level threshold mask (r<235 | g<210 | b<235)."""
    return ((patch_rgb[..., 0] < 235) | (patch_rgb[..., 1] < 210)
            | (patch_rgb[..., 2] < 235))
