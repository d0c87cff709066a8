"""ROI / bounding-box helpers over tissue masks (host-side numpy/cv2).

Parity targets: ``get_bbox`` (``reference DigiPathAI/helpers/utils.py:221-231``),
``get_all_bbox_masks`` (``:233-254``), ``get_all_bbox_masks_with_stride``
(``:256-278``), ``find_largest_bbox`` (``:280-305``) and ``labelthreshold``
(``:408-411``).  These power the reference's alternate ROI-masking strategies
(commented-out call sites at ``reference loaders/dataloader.py:272-274``);
kept as first-class utilities so those strategies are available here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_bboxes(mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """External-contour bounding boxes [(x, y, w, h), ...] of a binary mask."""
    import cv2

    m = (np.asarray(mask) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return [cv2.boundingRect(c) for c in contours]


def get_all_bbox_masks(mask: np.ndarray, stride_factor: int = 0) -> np.ndarray:
    """Union of all blob bounding boxes, each padded by ``stride_factor``."""
    mask = np.asarray(mask)
    out = np.zeros_like(mask, dtype=np.uint8)
    h, w = mask.shape
    for x, y, bw, bh in get_bboxes(mask):
        x0 = max(0, x - stride_factor)
        y0 = max(0, y - stride_factor)
        x1 = min(w, x + bw + stride_factor)
        y1 = min(h, y + bh + stride_factor)
        out[y0:y1, x0:x1] = 1
    return out


def get_all_bbox_masks_with_stride(mask: np.ndarray,
                                   stride_factor: int) -> np.ndarray:
    """Like ``get_all_bbox_masks`` but only strided grid points are set."""
    mask = np.asarray(mask)
    out = np.zeros_like(mask, dtype=np.uint8)
    h, w = mask.shape
    for x, y, bw, bh in get_bboxes(mask):
        x0 = max(0, x - stride_factor)
        y0 = max(0, y - stride_factor)
        x1 = min(w, x + bw + stride_factor)
        y1 = min(h, y + bh + stride_factor)
        out[y0:y1:stride_factor, x0:x1:stride_factor] = 1
    return out


def find_largest_bbox(mask: np.ndarray, stride_factor: int = 0) -> np.ndarray:
    """One box covering every nonzero pixel, padded by ``stride_factor``."""
    mask = np.asarray(mask)
    out = np.zeros_like(mask, dtype=np.uint8)
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return out
    h, w = mask.shape
    y0 = max(0, ys.min() - stride_factor)
    y1 = min(h, ys.max() + 1 + stride_factor)
    x0 = max(0, xs.min() - stride_factor)
    x1 = min(w, xs.max() + 1 + stride_factor)
    out[y0:y1, x0:x1] = 1
    return out


def labelthreshold(image: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binary 0/1 label map at ``threshold`` (reference ``labelthreshold``)."""
    return (np.asarray(image) >= threshold).astype(np.uint8)


def get_image_patch(image, coords, size: int):
    """``size``-square crop of ``image`` centred at ``coords`` (x, y).

    Parity target: ``getImagePatch`` (``reference DigiPathAI/helpers/
    utils.py:312-318``, legacy in-RAM dataset path).  The reference slices
    ``image[x-size//2 : x+size//2]`` unclamped, so a centre within
    ``size//2`` of the left/top edge hits a negative start and silently
    returns a wrong (wrapped or empty) crop; here the window is clamped
    into bounds with ``get_index``'s shrinking semantics, matching what
    the live dataset does at edges (``loaders/dataloader.py:340-390``).
    """
    image = np.asarray(image)
    x, y = coords
    lo_x, hi_x = get_index(x, image.shape[0], size)
    lo_y, hi_y = get_index(y, image.shape[1], size)
    return image[x - lo_x:x + hi_x, y - lo_y:y + hi_y]


def get_index(coord_ax: int, probs_map_shape_ax: int, grid_ax: int):
    """Clamped half-extents of a ``grid_ax``-wide window centred at
    ``coord_ax`` inside a ``probs_map_shape_ax``-long axis.

    Parity target: ``get_index`` (``reference DigiPathAI/helpers/utils.py:
    524-543``, dead code there) — returns ``(_min, _max)`` such that
    ``coord_ax - _min >= 0`` and ``coord_ax + _max <= probs_map_shape_ax``,
    shrinking each side independently from ``grid_ax // 2``.  The same
    clamping is what the planner applies to edge supertiles
    (``engine/planner.py``); exposed by name for inventory parity.
    """
    half = grid_ax // 2
    lo = half - max(0, half - coord_ax)
    hi = half - max(0, coord_ax + half - probs_map_shape_ax)
    return lo, hi
