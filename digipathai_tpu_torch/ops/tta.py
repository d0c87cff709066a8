"""Dihedral test-time augmentation on (B, X, Y, ...) tensors (``digipathai_tpu/ops/tta.py``).

Patches are in the reference's (x, y, c) orientation, so the spatial axes of
a batch are 1 and 2; ``FLIP_LEFT_RIGHT`` is ``np.fliplr`` per image, which
flips batch axis 2.  ``torch.rot90`` follows ``np.rot90``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

DEFAULT = "DEFAULT"
FLIP_LEFT_RIGHT = "FLIP_LEFT_RIGHT"
ROTATE_90 = "ROTATE_90"
ROTATE_180 = "ROTATE_180"
ROTATE_270 = "ROTATE_270"

ALLOWED = (FLIP_LEFT_RIGHT, ROTATE_90, ROTATE_180, ROTATE_270)

ALIASES = {
    "hflip": FLIP_LEFT_RIGHT, "fliplr": FLIP_LEFT_RIGHT,
    "rot90": ROTATE_90, "rotate90": ROTATE_90,
    "rot180": ROTATE_180, "rotate180": ROTATE_180,
    "rot270": ROTATE_270, "rotate270": ROTATE_270,
    "none": DEFAULT, "identity": DEFAULT,
}

_ROT = {ROTATE_90: 1, ROTATE_180: 2, ROTATE_270: 3}


def apply(batch: torch.Tensor, tta: str) -> torch.Tensor:
    """Forward transform of a (B, X, Y, ...) batch."""
    if tta == FLIP_LEFT_RIGHT:
        return torch.flip(batch, dims=(2,))
    if tta in _ROT:
        return torch.rot90(batch, _ROT[tta], dims=(1, 2))
    return batch


def invert(batch: torch.Tensor, tta: str) -> torch.Tensor:
    """Inverse transform for predictions."""
    if tta == FLIP_LEFT_RIGHT:
        return torch.flip(batch, dims=(2,))
    if tta in _ROT:
        return torch.rot90(batch, 4 - _ROT[tta], dims=(1, 2))
    return batch


def resolve_tta_list(tta_list) -> List[str]:
    """'DEFAULT' is always first; aliases normalize case-insensitively and
    an explicit 'DEFAULT' is deduped."""
    if tta_list is None:
        return [DEFAULT]
    norm = []
    for t in tta_list:
        u = ALIASES.get(str(t).lower(), str(t).upper())
        if u not in ALLOWED and u != DEFAULT:
            raise ValueError(
                f"unknown TTA {t!r}; allowed: {list(ALLOWED)} "
                f"(or aliases {sorted(ALIASES)})")
        norm.append(u)
    return [DEFAULT] + [t for t in norm if t != DEFAULT]


def effective_transforms(tta_list: Sequence[str],
                         faithful: bool = False) -> List[List[str]]:
    """Forward transform chain per TTA step.  ``faithful=True`` reproduces
    the reference's in-place compounding: step i applies [t1, ..., ti] while
    only ti is inverted."""
    chains: List[List[str]] = []
    acc: List[str] = []
    for t in tta_list:
        if faithful:
            if t != DEFAULT:
                acc = acc + [t]
            chains.append(list(acc))
        else:
            chains.append([] if t == DEFAULT else [t])
    return chains


def apply_chain(batch: torch.Tensor, chain: Sequence[str]) -> torch.Tensor:
    for t in chain:
        batch = apply(batch, t)
    return batch
