"""The probability, variance and count maps of a slide, computed plainly.

Patch mode (the reference's own algorithm): every planned patch, read in
the reference's (x, y, c) layout and normalised to (v - 128) / 128, goes
through every model under every test-time transform; the predictions'
p(class 1), each transformed back, give a per-patch mean and (biased)
variance, added into slide-sized sums with a count per pixel; the maps are
sum / max(count, 1) and var-sum / max(count, 1)^2.  Sums are float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import Net

#: test-time transforms: name -> (forward on (N, C, X, Y), inverse on
#: (N, X, Y)); a left-right flip flips each image's y axis
TTA = {
    "DEFAULT": (lambda x: x, lambda p: p),
    "FLIP_LEFT_RIGHT": (lambda x: torch.flip(x, (3,)),
                        lambda p: torch.flip(p, (2,))),
    "ROTATE_90": (lambda x: torch.rot90(x, 1, (2, 3)),
                  lambda p: torch.rot90(p, 3, (1, 2))),
    "ROTATE_180": (lambda x: torch.rot90(x, 2, (2, 3)),
                   lambda p: torch.rot90(p, 2, (1, 2))),
    "ROTATE_270": (lambda x: torch.rot90(x, 3, (2, 3)),
                   lambda p: torch.rot90(p, 1, (1, 2))),
}


def normalize(u8_nxyc: torch.Tensor) -> torch.Tensor:
    """(N, X, Y, 3) uint8 -> (N, 3, X, Y) float32 in [-1, 1)."""
    return ((u8_nxyc.float() - 128.0) / 128.0).permute(0, 3, 1, 2)


def predict(models, x, tta):
    """Mean and biased variance over models x transforms of p(class 1),
    (N, X, Y) each; ``models`` is a list of (forward, Net)."""
    preds = []
    for forward, net in models:
        for t in tta:
            fwd, inv = TTA[t]
            preds.append(inv(forward(net, fwd(x))))
    st = torch.stack(preds)
    return st.mean(0), st.var(0, unbiased=False)


def patch_maps(img: np.ndarray, groups: dict, models, tta, patch: int,
               device, batch: int = 32):
    """(mean, var, count) float32 (Y, X) maps of patch mode over the
    level-0 image ``img`` (Y, X, 3) and the plan's ``groups``."""
    Y, X = img.shape[:2]
    msum = torch.zeros((Y, X), dtype=torch.float64, device=device)
    vsum = torch.zeros_like(msum)
    count = torch.zeros_like(msum)
    coords = np.concatenate(list(groups.values())) if groups else np.zeros(
        (0, 2), np.int64)
    with torch.no_grad():
        for i in range(0, len(coords), batch):
            cb = coords[i:i + batch]
            u8 = np.stack([img[y:y + patch, x:x + patch].transpose(1, 0, 2)
                           for x, y in cb.tolist()])
            x = normalize(torch.from_numpy(u8).to(device))
            mean, var = predict(models, x, tta)
            for j, (px, py) in enumerate(cb.tolist()):
                msum[py:py + patch, px:px + patch] += mean[j].T.double()
                vsum[py:py + patch, px:px + patch] += var[j].T.double()
                count[py:py + patch, px:px + patch] += 1
    c = torch.clamp(count, min=1.0)
    return ((msum / c).float().cpu().numpy(),
            (vsum / (c * c)).float().cpu().numpy(),
            count.float().cpu().numpy())


def load_models(names, params, lowp, modules):
    """(forward, Net) per model name; ``params[name]`` its weights,
    ``modules[name]`` its reference module."""
    return [(modules[n].forward, Net(params[n], lowp)) for n in names]

