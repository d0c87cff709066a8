"""Bilinear resize with TF1 ``align_corners=True`` semantics
(``digipathai_tpu/ops/resize.py``).

DeepLabv3+ upsamples with ``tf.compat.v1.image.resize(...,
align_corners=True)``: source position ``i * (in - 1) / (out - 1)``,
linear interpolation, per axis.  As in JAX, the positions are computed in
float64 and the weights rounded to float32, the interpolation runs in f32,
rows first, and the result is cast back to the input's dtype once.  The
tables are computed on the input's device: uploading them from the host
would make every call wait for the device's queue.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis_tables(n_in: int, n_out: int, device):
    """(i0, i1, w1): the source rows below and above each output row and
    the weight of the one above (``digipathai_tpu/ops/resize.py``'s
    numpy tables, computed alike)."""
    if n_out <= 1 or n_in <= 1:
        i0 = torch.zeros(n_out, dtype=torch.int64, device=device)
        return i0, i0, torch.zeros(n_out, device=device)
    pos = torch.arange(n_out, dtype=torch.float64, device=device) * (
        n_in - 1) / (n_out - 1)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return i0, i1, (pos - i0).to(torch.float32)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (B, H, W, C) or (B, H, W) along axes 1-2, align_corners=True;
    f32 arithmetic, one rounding to x.dtype."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    xf = x.float()

    def table(n_in, n_out, axis):
        i0, i1, w1 = _axis_tables(n_in, n_out, x.device)
        shape = [1] * x.dim()
        shape[axis] = n_out
        return i0, i1, w1.reshape(shape)

    i0, i1, w1 = table(x.shape[1], oh, 1)
    xf = xf[:, i0] * (1.0 - w1) + xf[:, i1] * w1
    j0, j1, v1 = table(x.shape[2], ow, 2)
    xf = xf[:, :, j0] * (1.0 - v1) + xf[:, :, j1] * v1
    return xf.to(x.dtype)
