"""Model weights for the port (``digipathai_tpu/models/weights.py``).

Trained checkpoints are the upstream ``.h5`` release assets.  A torch
loader for them is not written yet (ROADMAP.md §A item 2), so a checkpoint
that is present raises rather than being replaced silently by random
weights.  Without one, the seeded random init stands in, with the JAX
engine's warning and ``status["weights"] = "random"``.  Nothing downloads.
"""

from __future__ import annotations

import warnings

from digipathai_tpu.models.weights import MODES, cache_dir, h5_path

__all__ = ["MODES", "cache_dir", "h5_path", "load_variables"]


def load_variables(bundle, mode: str, model: str, patch_size: int = 256,
                   status=None, allow_random: bool = True, seed: int = 0):
    """The module of ``bundle`` with weights for ``mode``/``model``."""
    h5 = h5_path(mode, model)
    if h5.exists():
        raise NotImplementedError(
            f"trained checkpoint {h5} found, but the .h5 -> torch loader is "
            f"not ported yet (ROADMAP.md §A item 2)")
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
