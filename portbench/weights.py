"""Random weights from the seed, made on the device and written where the
program loads trained weights from.

Every conv kernel is a truncated normal (at two standard deviations) of
variance ``scale / fan_in``, as the models' own initialisers draw; every
BatchNorm's ``scale`` and ``var`` is uniform on [0.5, 1.5) and its
``bias`` and ``mean``, and every conv bias, normal with deviation 0.1, so
that the statistics differ from the identity and the maps vary.  Each
kind is drawn in one call over all of a model's tensors of that kind.

The file is the program's converted-weights cache
(``<DPAI_CACHE>/converted/<family>_<model>.torch.npz``, a flat ``np.savez``
of float32 arrays named ``<layer>.<leaf>``), which the program reads on
every ``getSegmentation`` call and the reference reads too.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

FAMILY = {"colon": "digestpath", "liver": "paip", "breast": "camelyon"}


def model_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for model ``index`` of a run's ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), 1 + index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make(shapes, seed: int, device) -> dict:
    """``{name: float32 tensor on device}`` for ``shapes``
    (``Shapes.items``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kinds = {"kernel": [], "scale": [], "shift": []}
    for name, (shape, kind, _) in shapes.items():
        kinds[kind].append(name)
    out = {}
    for kind, names in kinds.items():
        sizes = [int(np.prod(shapes[n][0])) for n in names]
        buf = torch.empty(sum(sizes), device=device)
        if kind == "kernel":
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0,
                                        generator=g)
            std = torch.tensor(
                [(shapes[n][2] / np.prod(shapes[n][0][:3])) ** 0.5
                 / 0.87962566103423978 for n in names], device=device)
            buf *= torch.repeat_interleave(
                std, torch.tensor(sizes, device=device))
        elif kind == "scale":
            buf.uniform_(0.5, 1.5, generator=g)
        else:
            buf.normal_(0.0, 0.1, generator=g)
        for n, part in zip(names, torch.split(buf, sizes)):
            out[n] = part.view(shapes[n][0])
    return out


def path(cache: Path, mode: str, model: str) -> Path:
    return Path(cache) / "converted" / f"{FAMILY[mode]}_{model}.torch.npz"


def save(params: dict, dst: Path) -> Path:
    """Write ``params`` as the program's converted cache file (atomic)."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name("tmp-" + dst.name)
    with open(tmp, "wb") as f:
        np.savez(f, **{k: v.detach().float().cpu().numpy()
                       for k, v in params.items()})
    os.replace(tmp, dst)
    return dst


def load(src: Path, device) -> dict:
    """The file's arrays as float32 tensors on ``device``."""
    with np.load(src) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}
