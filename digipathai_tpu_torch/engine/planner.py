"""Patch-grid planning: tissue mask -> static-shape supertile work units.

Port of ``digipathai_tpu/engine/planner.py``: the same plan dataclasses
and numpy logic (patch centers on the strided mask, clamped level-0 reads,
grouped by the supertile of their top-left corner and padded to whole
batches); the tissue mask is the torch ``plan_mask`` on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.morphology import plan_mask

__all__ = ["PatchPlan", "SupertileGroup", "plan_patches"]


@dataclass
class SupertileGroup:
    origin: Tuple[int, int]       # level-0 (x, y) of the supertile corner
    coords: np.ndarray            # (n, 2) int32 level-0 patch top-lefts (padded)
    valid: np.ndarray             # (n,) bool — False for padding

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


@dataclass
class PatchPlan:
    slide_dims: Tuple[int, int]   # (X, Y) level-0, width-first
    patch: int
    stride: int
    supertile: int
    batch: int
    mask_level: int
    resolution: int               # level-0 pixels per mask pixel
    groups: List[SupertileGroup]
    tissue_mask: np.ndarray       # (X_mask, Y_mask) bool, post-morphology
    strided_mask: np.ndarray      # (X_mask, Y_mask) bool

    @property
    def total_patches(self) -> int:
        return sum(g.n_valid for g in self.groups)

    @property
    def total_batches(self) -> int:
        return sum(len(g.coords) // self.batch for g in self.groups)


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
