"""Otsu thresholding on tensors (``digipathai_tpu/ops/otsu.py``).

A 256-bin histogram over [min, max] and the between-class variance swept
with cumulative moments, as ``skimage.filters.threshold_otsu`` does.
"""

from __future__ import annotations

import torch


def otsu_threshold(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Scalar Otsu threshold of ``x`` (any shape, any real dtype), f32."""
    x = x.float().reshape(-1)
    lo = x.min()
    hi = x.max()
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo) / span * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).float()
    centers = lo + (torch.arange(nbins, dtype=torch.float32) + 0.5) * (span / nbins)

    w1 = torch.cumsum(hist, 0)
    w2 = torch.cumsum(hist.flip(0), 0).flip(0)
    m1 = torch.cumsum(hist * centers, 0) / torch.clamp(w1, min=1e-12)
    m2 = (torch.cumsum((hist * centers).flip(0), 0)
          / torch.clamp(w2.flip(0), min=1e-12)).flip(0)
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    # ties go to the first maximum, as jnp.argmax does
    i = int(torch.nonzero(var_between == var_between.max())[0, 0])
    return centers[i]
