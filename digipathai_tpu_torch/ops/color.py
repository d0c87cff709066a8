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


def normalize_minmax(data):
    """Min-max contrast normalization of a host array to [0, 1]; all zeros
    when it is constant (the reference's ``normalize_minmax``, whose
    ``np.float`` alias numpy has removed: its evident intent)."""
    import numpy as np

    data = np.asarray(data)
    lo = float(data.min())
    hi = float(data.max())
    if hi - lo == 0:
        return np.zeros_like(data, dtype=np.float64 if data.dtype.kind != "f"
                             else data.dtype)
    return (data - lo) / (hi - lo)
