"""The comparison that decides ``correct``: the program's outputs for a
slide against the reference's maps of the same slide.

A cell compares the numbers its traffic file gives limits for (value <=
limit passes), each over the whole slide:

- ``map_max_gap``: the largest |program - reference| over every pixel of
  the probability map and of the variance map;
- ``map_mean_gap``: the mean |program - reference| of the probability map
  over the pixels some patch covers;
- ``count_bad_px``: pixels whose overlap count differs (the plan);
- ``mask_bad_px``: pixels of the returned mask that disagree with the
  reference's map thresholded, where that map lies farther from the
  threshold than the ``map_max_gap`` limit;
- ``tiff_levels_bad``: pyramid levels missing, extra or of the wrong size,
  over the three written pyramids;
- ``tiff_gap``: the largest gap, in 8-bit levels, between the mean of an
  aligned 8 x 8 block of a written pyramid's full-resolution level (one
  JPEG block) and the same block of the reference's 8-bit image; blocks of
  the mask pyramid that hold a pixel that near the threshold are left
  out.
"""

from __future__ import annotations

import numpy as np

from .reference import tiff

NAMES = ("map_max_gap", "map_mean_gap", "count_bad_px", "mask_bad_px",
         "tiff_levels_bad", "tiff_gap")


def pyramid_dims(width: int, height: int, tile: int = 256) -> list:
    """The levels a pyramid of a width x height map holds: halved (floor)
    until the longer side fits in one tile."""
    dims = [(width, height)]
    while max(dims[-1]) > tile:
        w, h = dims[-1]
        dims.append((max(1, w // 2), max(1, h // 2)))
    return dims


def _u8(a):
    return np.clip(np.round(a * 255.0), 0, 255)


def _blocks(a):
    h, w = a.shape[0] // 8 * 8, a.shape[1] // 8 * 8
    return a[:h, :w].reshape(h // 8, 8, w // 8, 8).mean(axis=(1, 3))


def judge(prog: dict, ref: dict, limits: dict, threshold: float) -> dict:
    """``{name: value}`` of one slide for the names in ``limits``.
    ``prog``: ``mean``, ``var``, ``count`` (Y, X) float32 maps, ``mask``
    the returned (X, Y) uint8 array and ``tiffs`` {probs, mask,
    uncertainty: path}; ``ref``: ``mean``, ``var``, ``count``."""
    mean_r = ref["mean"]
    Y, X = mean_r.shape
    gap = np.abs(np.asarray(prog["mean"], np.float32) - mean_r)
    vgap = np.abs(np.asarray(prog["var"], np.float32) - ref["var"])
    covered = ref["count"] > 0
    out = {
        "map_max_gap": float(max(gap.max(), vgap.max())),
        "map_mean_gap": float(gap[covered].mean()) if covered.any() else 0.0,
        "count_bad_px": int((np.asarray(prog["count"]) != ref["count"]).sum()),
    }
    near = np.abs(mean_r - threshold) <= limits["map_max_gap"]
    mask_p = np.asarray(prog["mask"]).T >= 128
    out["mask_bad_px"] = int(((mask_p != (mean_r >= threshold)) & ~near).sum())

    want = pyramid_dims(X, Y)
    expect = {"probs": _u8(mean_r), "uncertainty": _u8(ref["var"]),
              "mask": np.where(mean_r >= threshold, 255.0, 0.0)}
    far = _blocks(near.astype(np.float64)) == 0
    bad_levels, worst = 0, 0.0
    for kind, path in prog["tiffs"].items():
        try:
            got = [(lv.width, lv.height) for lv in tiff.read_levels(path)]
            level0 = tiff.read_level(path, 0, channels=1)
        except (OSError, ValueError, KeyError, IndexError):
            bad_levels += len(want)
            worst = float("inf")
            continue
        bad_levels += sum(a != b for a, b in zip(got, want)) + abs(
            len(got) - len(want))
        if level0.shape != (Y, X):
            worst = float("inf")
            continue
        d = np.abs(_blocks(level0.astype(np.float64)) - _blocks(expect[kind]))
        if kind == "mask":
            d = d[far]
        worst = max(worst, float(d.max()) if d.size else 0.0)
    out["tiff_levels_bad"] = int(bad_levels)
    out["tiff_gap"] = worst
    return {k: v for k, v in out.items() if k in limits}


def verdict(numbers: list, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) over the judged slides: each
    number's worst value against its limit."""
    checks = {}
    for name in limits:
        worst = max(n[name] for n in numbers) if numbers else float("inf")
        checks[name] = {"value": worst, "limit": limits[name]}
    ok = bool(numbers) and all(c["value"] <= c["limit"]
                               for c in checks.values())
    return ok, checks
