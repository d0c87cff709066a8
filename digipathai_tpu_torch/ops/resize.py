"""Bilinear resize with TF1 ``align_corners=True`` semantics
(``digipathai_tpu/ops/resize.py``).

DeepLabv3+ upsamples with ``tf.compat.v1.image.resize(...,
align_corners=True)``: source position ``i * (in - 1) / (out - 1)``,
linear interpolation, per axis.  As in JAX, the positions are computed in
float64 and the weights rounded to float32, the interpolation runs in f32
(in f64 on an f64 input, where JAX's x64 forward keeps f32: an f64 model
then has no f32 step whose rounding a row-sharded forward would reorder),
rows first, and the result is cast back to the input's dtype once.  The
tables are computed on the input's device: uploading them from the host
would make every call wait for the device's queue.
"""

from __future__ import annotations

import math
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


def source_rows(n_in: int, n_out: int, a: int, b: int):
    """[lo, hi): the source rows that output rows [a, b) of an
    ``n_in -> n_out`` resize read, worked out on the host as
    ``_axis_tables`` computes them (float64, correctly rounded)."""
    if n_out <= 1 or n_in <= 1:
        return 0, 1
    lo = math.floor(a * (n_in - 1) / (n_out - 1))
    last = min(math.floor((b - 1) * (n_in - 1) / (n_out - 1)) + 1, n_in - 1)
    return lo, last + 1


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the interpolation's dtype: f32, or x's where it is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lerp(xf: torch.Tensor, i0, i1, w1, axis: int) -> torch.Tensor:
    """``xf`` interpolated along ``axis`` (1 or 2) between the rows (or
    columns) ``i0`` and ``i1``, weight ``w1`` (broadcast) on the second."""
    if axis == 1:
        return xf[:, i0] * (1.0 - w1) + xf[:, i1] * w1
    return xf[:, :, i0] * (1.0 - w1) + xf[:, :, i1] * w1


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (B, H, W, C) or (B, H, W) along axes 1-2, align_corners=True;
    f32 arithmetic (``wide``), one rounding to x.dtype."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    xf = wide(x)

    def table(n_in, n_out, axis):
        i0, i1, w1 = _axis_tables(n_in, n_out, x.device)
        shape = [1] * x.dim()
        shape[axis] = n_out
        return i0, i1, w1.reshape(shape)

    xf = lerp(xf, *table(x.shape[1], oh, 1), 1)
    xf = lerp(xf, *table(x.shape[2], ow, 2), 2)
    return xf.to(x.dtype)
