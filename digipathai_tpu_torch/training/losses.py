"""Training losses and the optimizer (``digipathai_tpu/training/losses.py``).

CE + 0.5 * soft Dice on softmax probabilities and one-hot labels, both
(N, H, W, 2) f32, and adam.  Each term is split at its sums (``ce_sums``,
``dice_sums``), so a data-parallel step takes the loss of the global batch
from the sums of every rank (``training/train.py``).
"""

from __future__ import annotations

import torch

CLIP_EPS = 1e-7     # CE's probabilities are clipped to [CLIP_EPS, 1]
SMOOTH = 1.0        # soft Dice's smoothing
DICE_WEIGHT = 0.5


def _clip(probs: torch.Tensor, eps: float) -> torch.Tensor:
    """``jnp.clip(probs, eps, 1)``: maximum, then minimum, so that a value
    on a bound takes half the gradient, as in JAX."""
    p = torch.maximum(probs, probs.new_full((), eps))
    return torch.minimum(p, p.new_full((), 1.0))


def ce_sums(probs: torch.Tensor, labels_onehot: torch.Tensor):
    """(sum over pixels of -sum_c g log p, the pixel count), stacked."""
    s = -(labels_onehot * torch.log(_clip(probs, CLIP_EPS))).sum()
    return torch.stack([s, s.new_full((), probs.numel() // probs.shape[-1])])


def ce_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """Mean CE from ``ce_sums``."""
    total, count = sums.unbind()
    return total / count


def dice_sums(probs: torch.Tensor, labels_onehot: torch.Tensor):
    """(sum p g, sum p, sum g) over the foreground channel, stacked, in
    the wider of the two dtypes (the CE term's product promotes alike; the
    models' probabilities are f32 even in an f64 model, as JAX's are)."""
    g = labels_onehot[..., 1]
    p = probs[..., 1].to(torch.promote_types(probs.dtype, g.dtype))
    return torch.stack([(p * g).sum(), p.sum(), g.sum()])


def dice_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """1 - soft Dice from ``dice_sums``."""
    pg, p, g = sums.unbind()
    return 1.0 - (2.0 * pg + SMOOTH) / (p + g + SMOOTH)


def categorical_crossentropy(probs: torch.Tensor,
                             labels_onehot: torch.Tensor) -> torch.Tensor:
    """Mean CE given *softmax probabilities* (Keras-style) and one-hot
    labels: the mean over pixels of the sum over classes."""
    return ce_from_sums(ce_sums(probs, labels_onehot))


def soft_dice_loss(probs: torch.Tensor,
                   labels_onehot: torch.Tensor) -> torch.Tensor:
    """1 - soft Dice of the foreground channel."""
    return dice_from_sums(dice_sums(probs, labels_onehot))


def loss_from_sums(ce: torch.Tensor, dice: torch.Tensor) -> torch.Tensor:
    """CE + DICE_WEIGHT * Dice from ``ce_sums`` and ``dice_sums``."""
    return ce_from_sums(ce) + DICE_WEIGHT * dice_from_sums(dice)


def segmentation_loss(probs: torch.Tensor,
                      labels_onehot: torch.Tensor) -> torch.Tensor:
    return loss_from_sums(ce_sums(probs, labels_onehot),
                          dice_sums(probs, labels_onehot))


def make_optimizer(params, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """optax's ``adam``: the same bias-corrected update, eps outside the
    square root."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)
