"""The patch step: normalize, model x TTA forward, stitch into the accumulator.

Port of ``digipathai_tpu/engine/infer.py``.  One call per batch: uint8
patches go to the device, are normalized there in the compute dtype, run
through every model and TTA chain, and their mean and variance are added
in place into the supertile accumulator.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import tta as tta_ops
from ..ops.color import normalize_patches
from ..ops.stitch import stitch_batch


def _predict(bundles, variables_list, x, chains, p1: bool):
    preds = []
    for bundle, variables in zip(bundles, variables_list):
        for chain in chains:
            xt = tta_ops.apply_chain(x, chain)
            p = (bundle.apply_p1 if p1 else bundle.apply)(variables, xt)
            preds.append(tta_ops.invert(p, chain[-1] if chain
                                        else tta_ops.DEFAULT))
    stack = torch.stack(preds)
    return stack.mean(0), stack.var(0, unbiased=False)


def build_step(bundles: Sequence, tta_list: Sequence[str], patch: int,
               faithful_tta: bool = False, compute_dtype=torch.bfloat16,
               mask_predictions: bool = False, device="cuda"):
    """Returns ``step(variables_list, acc, patches_u8, offsets, valid)``.

    ``variables_list`` holds one module per bundle, on ``device``; ``acc``
    is the device accumulator and is updated in place (and returned);
    ``patches_u8`` (B, P, P, 3) uint8, ``offsets`` (B, 2) and ``valid`` (B,)
    are host arrays.
    """
    chains = tta_ops.effective_transforms(tta_list, faithful=faithful_tta)

    def step(variables_list, acc, patches_u8, offsets, valid):
        with torch.inference_mode():
            u8 = torch.from_numpy(np.ascontiguousarray(patches_u8)).to(device)
            x = normalize_patches(u8, dtype=compute_dtype)
            mean, var = _predict(bundles, variables_list, x, chains, p1=True)
            if mask_predictions:
                # zero predictions outside patch-level tissue
                from ..ops.morphology import tissue_mask_patch

                tm = tissue_mask_patch(u8).to(mean.dtype)
                mean = mean * tm
                var = var * tm
            return stitch_batch(acc, mean, var, offsets, valid, patch=patch)

    return step


def predict_batch(bundles, variables_list, patches_u8, tta_list=("DEFAULT",),
                  faithful_tta: bool = False, compute_dtype=torch.bfloat16,
                  device="cuda"):
    """Ensemble x TTA mean/var of one batch, no stitching (debug/eval API)."""
    chains = tta_ops.effective_transforms(list(tta_list), faithful=faithful_tta)
    with torch.inference_mode():
        u8 = torch.as_tensor(np.asarray(patches_u8)).to(device)
        x = normalize_patches(u8, dtype=compute_dtype)
        return _predict(bundles, variables_list, x, chains, p1=False)
