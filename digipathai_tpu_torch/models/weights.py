"""Model weights for the port (``digipathai_tpu/models/weights.py``).

Trained checkpoints are the upstream ``.h5`` release assets.  A torch
loader for them is not written yet (ROADMAP.md §A item 4), so a checkpoint
that is present raises rather than being replaced silently by random
weights.  Without one, the seeded random init stands in, with the JAX
engine's warning and ``status["weights"] = "random"``.  Nothing downloads.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

__all__ = ["MODES", "cache_dir", "h5_path", "load_variables"]

MODES = {"colon": "digestpath", "liver": "paip", "breast": "camelyon"}

_H5_NAME = {"dense": "densenet", "inception": "inception", "deeplabv3": "deeplabv3"}


def cache_dir() -> Path:
    root = os.environ.get("DPAI_CACHE", os.path.join(os.path.expanduser("~"), ".DigiPathAI"))
    return Path(root)


def h5_path(mode: str, model: str) -> Path:
    fam = MODES[mode]
    return cache_dir() / f"{fam}_models" / f"{fam}_{_H5_NAME[model]}.h5"


def load_variables(bundle, mode: str, model: str, patch_size: int = 256,
                   status=None, allow_random: bool = True, seed: int = 0):
    """The module of ``bundle`` with weights for ``mode``/``model``."""
    h5 = h5_path(mode, model)
    if h5.exists():
        raise NotImplementedError(
            f"trained checkpoint {h5} found, but the .h5 -> torch loader is "
            f"not ported yet (ROADMAP.md §A item 4)")
    if not allow_random:
        raise IOError(
            f"weights for {mode}/{model} unavailable and allow_random=False")
    warnings.warn(
        f"trained weights for {mode}/{model} are unavailable "
        f"(offline or download failed) — falling back to RANDOM "
        f"initialization; segmentation output will be meaningless. "
        f"Pass allow_random_weights=False to fail instead.",
        stacklevel=2)
    if status is not None:
        status["weights"] = "random"
    return bundle.init(patch_size, seed=seed)
