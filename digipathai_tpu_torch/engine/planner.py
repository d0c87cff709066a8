"""Patch-grid planning: tissue mask -> static-shape supertile work units.

Port of ``digipathai_tpu/engine/planner.py::plan_patches``.  The plan's
dataclasses are the JAX package's (they hold numpy only); the tissue mask is
the torch ``plan_mask`` on the CPU, and the rest is the same numpy logic:
patch centers on the strided mask, clamped level-0 reads, grouped by the
supertile of their top-left corner and padded to whole batches.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from digipathai_tpu.engine.planner import PatchPlan, SupertileGroup

from ..ops.morphology import plan_mask

__all__ = ["PatchPlan", "SupertileGroup", "plan_patches"]


def plan_patches(slide, patch: int = 256, stride: int = 128, batch: int = 32,
                 supertile: int = 4096, roi_masking: bool = True,
                 mask_level: int = -1) -> PatchPlan:
    """Build the static-shape patch plan for one slide."""
    level = slide.level_count - 1  # the reference forces the coarsest level
    downsample = int(round(slide.level_downsamples[level]))

    X_slide, Y_slide = slide.dimensions
    img = slide.read_level(level)                      # (h, w, 3)
    # flat pyramids: decimate a huge "coarsest" level by powers of 2 to
    # <= 64 MP, keeping the power-of-2 resolution invariant
    extra = 1
    while (img.shape[0] // extra) * (img.shape[1] // extra) > (1 << 26):
        extra *= 2
    if extra > 1:
        img = img[::extra, ::extra]
        downsample *= extra
    stride_lvl = max(1, stride // downsample)
    img_xyc = np.ascontiguousarray(np.transpose(img, (1, 0, 2)))  # (X, Y, 3)

    mask = plan_mask(torch.from_numpy(img_xyc), min(level, 4)).numpy()

    X_mask, Y_mask = mask.shape
    if X_slide // X_mask != Y_slide // Y_mask:
        raise ValueError(
            f"slide/mask dimension mismatch: {X_slide}/{X_mask} vs {Y_slide}/{Y_mask}")
    resolution = int(round(X_slide / X_mask))
    if resolution < 1 or 2 ** int(math.log2(resolution)) != resolution:
        raise ValueError(f"resolution (X_slide / X_mask) is not a power of 2: {resolution}")

    strided = np.zeros_like(mask)
    if roi_masking:
        strided[::stride_lvl, ::stride_lvl] = mask[::stride_lvl, ::stride_lvl]
    else:
        strided[::stride_lvl, ::stride_lvl] = True

    xi, yi = np.nonzero(strided)
    # centered level-0 reads, clamped to bounds
    xs = np.clip(xi.astype(np.int64) * resolution - patch // 2, 0, X_slide - patch)
    ys = np.clip(yi.astype(np.int64) * resolution - patch // 2, 0, Y_slide - patch)

    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for x, y in zip(xs.tolist(), ys.tolist()):
        key = (int(x // supertile) * supertile, int(y // supertile) * supertile)
        groups.setdefault(key, []).append((x, y))

    out: List[SupertileGroup] = []
    for origin in sorted(groups):
        pts = np.asarray(groups[origin], np.int32)
        n = len(pts)
        padded = max(batch, ((n + batch - 1) // batch) * batch)
        coords = np.zeros((padded, 2), np.int32)
        coords[:n] = pts
        coords[n:] = [origin[0], origin[1]]  # in-bounds dummy reads
        valid = np.zeros((padded,), bool)
        valid[:n] = True
        out.append(SupertileGroup(origin=origin, coords=coords, valid=valid))

    return PatchPlan(
        slide_dims=(X_slide, Y_slide), patch=patch, stride=stride,
        supertile=supertile, batch=batch, mask_level=level,
        resolution=resolution, groups=out,
        tissue_mask=mask.astype(bool), strided_mask=strided.astype(bool),
    )
