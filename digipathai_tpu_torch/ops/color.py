"""Color-space ops on tensors (``digipathai_tpu/ops/color.py``)."""

from __future__ import annotations

import torch


def rgb_to_hsv_saturation(rgb: torch.Tensor) -> torch.Tensor:
    """Saturation channel of HSV for a (..., 3) RGB image.

    Matches ``skimage.color.rgb2hsv(img)[..., 1]``: uint8 input is scaled to
    [0, 1]; S = (max - min) / max, with S = 0 where max == 0.
    """
    x = rgb.float()
    if rgb.dtype == torch.uint8:
        x = x / 255.0
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    return torch.where(mx > 0, (mx - mn) / torch.clamp(mx, min=1e-12),
                       torch.zeros_like(mx))


def normalize_patches(patches_u8: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """(x - 128) / 128 in ``dtype``, on the patches' device."""
    return (patches_u8.to(dtype) - 128.0) / 128.0
