"""Overlap-add stitching of patch predictions into a supertile accumulator.

Port of ``digipathai_tpu/ops/stitch.py``.  The accumulator is
(planes, S + patch, S + patch) float32 on the device, indexed (x, y) like the
patches; ``stitch_batch`` adds each patch into its window in place.
``add_counts_host`` is the JAX module's numpy function, copied because that
module imports jax at the top.
"""

from __future__ import annotations

import numpy as np
import torch


def stitch_batch(acc: torch.Tensor, mean_p: torch.Tensor, var_p: torch.Tensor,
                 offsets, valid, *, patch: int) -> torch.Tensor:
    """Scatter-add a batch of patch stats into ``acc`` in place.

    acc: (C, S+patch, S+patch) f32, C=2 (mean-sum, var-sum) or C=3 (with a
    count plane); mean_p/var_p: (B, patch, patch) f32; offsets: (B, 2) host
    ints, (dx, dy) inside the accumulator; valid: (B,) host bools, weighting
    each patch by 0 or 1.  Returns ``acc``.
    """
    planes = [mean_p, var_p]
    if acc.shape[0] == 3:
        planes.append(torch.ones_like(mean_p))
    upd = torch.stack(planes, 0)                      # (C, B, P, P)
    offsets = np.asarray(offsets)
    valid = np.asarray(valid)
    for i in range(upd.shape[1]):
        dx, dy = int(offsets[i, 0]), int(offsets[i, 1])
        acc[:, dx:dx + patch, dy:dy + patch].add_(upd[:, i],
                                                  alpha=float(valid[i]))
    return acc


def make_accumulator(supertile: int, patch: int, planes: int = 3,
                     device="cuda") -> torch.Tensor:
    return torch.zeros((planes, supertile + patch, supertile + patch),
                       dtype=torch.float32, device=device)


def add_counts_host(count_map, coords, valid, patch: int):
    """Analytic count-plane accumulation on the host, vectorized.

    ``count_map`` is the (Y, X) memmap; ``coords`` are absolute level-0
    (x, y) patch top-lefts.  Each patch is a +1 rectangle: the counts are a
    2D difference array over the row breakpoints, integrated with two
    cumsums and broadcast-added span by span.
    """
    coords = np.asarray(coords)[np.asarray(valid, bool)]
    if coords.size == 0:
        return
    Y, X = count_map.shape
    xs = coords[:, 0].astype(np.int64)
    ys = coords[:, 1].astype(np.int64)
    x0r, y0r = int(xs.min()), int(ys.min())
    x1r = min(int(xs.max()) + patch, X)
    y1r = min(int(ys.max()) + patch, Y)
    H, W = y1r - y0r, x1r - x0r
    ya, yb = ys - y0r, np.minimum(ys + patch, Y) - y0r
    xa, xb = xs - x0r, np.minimum(xs + patch, X) - x0r

    bps = np.unique(np.concatenate([ya, yb]))
    if len(bps) * (W + 1) * 4 > (128 << 20):
        # non-grid scatter: bound the profile array by splitting at the
        # median row (planner grids never get here)
        lo = ys <= np.median(ys)
        ones = np.ones(len(coords), bool)
        add_counts_host(count_map, coords[lo], ones[lo], patch)
        add_counts_host(count_map, coords[~lo], ones[~lo], patch)
        return
    ia = np.searchsorted(bps, ya)
    ib = np.searchsorted(bps, yb)
    prof = np.zeros((len(bps), W + 1), np.float32)
    np.add.at(prof, (ia, xa), 1.0)
    np.add.at(prof, (ia, xb), -1.0)
    np.add.at(prof, (ib, xa), -1.0)
    np.add.at(prof, (ib, xb), 1.0)
    np.cumsum(prof, axis=0, out=prof)
    np.cumsum(prof, axis=1, out=prof)
    span_ends = np.append(bps[1:], H)
    region = count_map[y0r:y1r, x0r:x1r]
    for k in range(len(bps)):
        if bps[k] >= H:
            break
        region[bps[k]:span_ends[k]] += prof[k, :-1]


def finalize_maps(mean_sum, var_sum, count):
    """count=0 -> 1, mean /= count, var /= count**2 (the reference's
    ``var / count**2``)."""
    c = torch.clamp(count, min=1.0)
    return mean_sum / c, var_sum / (c * c)


def get_mean_img(probs, count_map):
    """Per-pixel mean and variance over a stack of overlap-add maps, each
    divided by ``count_map`` (0 counts as 1): the reference's dead-code
    ``get_mean_img``, whose body overwrites its result with zeros; its
    evident intent, on host arrays.  The engine computes the same on the
    device (``finalize_maps``)."""
    probs = np.array(list(probs), dtype=np.float32)
    counts = np.maximum(np.asarray(count_map, np.float32), 1.0)[None, ...]
    probs = probs / counts
    return np.mean(probs, axis=0), np.var(probs, axis=0)
