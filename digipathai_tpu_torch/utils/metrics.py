"""Segmentation metrics (host-side numpy; small inputs)."""

from __future__ import annotations

import numpy as np


def jaccard(x: np.ndarray, y: np.ndarray, smoothing: float = 1.0) -> float:
    """Jaccard with smoothing; 255-valued masks are treated as 1.

    Parity: ``calc_jacc_score`` (``reference DigiPathAI/helpers/utils.py:414-420``).
    """
    x = (np.asarray(x) > 0).astype(np.int64)
    y = (np.asarray(y) > 0).astype(np.int64)
    num = (x * y).sum()
    den = np.logical_or(x, y).sum()
    return float((num + smoothing) / (den + smoothing))


def dice(x: np.ndarray, y: np.ndarray, eps: float = 1e-3) -> float:
    """Dice-style IoU lambda (``reference DigiPathAI/helpers/utils.py:484``)."""
    x = (np.asarray(x) > 0).astype(np.int64)
    y = (np.asarray(y) > 0).astype(np.int64)
    return float(2.0 * (x * y).sum() / ((x + y).sum() + eps))
