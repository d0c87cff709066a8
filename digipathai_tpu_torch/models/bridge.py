"""flax variables -> the port's modules, name to name.

The JAX package's variables are ``{'params': {layer: {'kernel', 'bias',
'scale'}}, 'batch_stats': {layer: {'mean', 'var'}}}`` under Keras-mirrored
layer names.  The port's modules carry the same layer names and store
parameters in flax's layouts (HWIO kernels), so each leaf copies to the
tensor ``<layer>.<leaf>``.  Parity tests feed both packages from one tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


_STATS = ("mean", "var")  # the leaves that are buffers: flax's batch_stats


def torch_to_flax(module: nn.Module) -> Dict[str, dict]:
    """The module's state as a flax variables tree of f32 numpy arrays:
    BatchNorm ``mean``/``var`` under 'batch_stats', every other leaf under
    'params'."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in module.state_dict().items():
        layer, leaf = name.rsplit(".", 1)
        coll = "batch_stats" if leaf in _STATS else "params"
        out[coll].setdefault(layer, {})[leaf] = (
            t.detach().to("cpu", torch.float32).numpy().copy())
    return {k: v for k, v in out.items() if v}


def flax_to_torch(variables_np, module: nn.Module) -> nn.Module:
    """Load a flax variables tree (nested dicts of arrays) into ``module``.

    Every leaf of 'params' and 'batch_stats' must name a parameter or
    buffer of the module with the same shape, and every parameter and
    buffer must be named by a leaf; otherwise it raises ``KeyError``
    (names) or ``ValueError`` (shapes).  A 'calib' collection sets the
    named convs' ``amax``.  Returns ``module``.
    """
    leaves = {}
    for collection in ("params", "batch_stats"):
        leaves.update(_flatten(variables_np.get(collection, {})))
    unknown = set(variables_np) - {"params", "batch_stats", "calib"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    load_flat(leaves, module)
    if "calib" in variables_np:
        from .quant import set_calib

        set_calib(module, variables_np["calib"])
    return module


def load_flat(leaves: Dict[str, np.ndarray], module: nn.Module) -> nn.Module:
    """Load ``{'<layer>.<leaf>': array}`` into ``module`` with the checks of
    ``flax_to_torch``; the arrays are copied as f32."""
    state = module.state_dict()
    missing = sorted(set(state) - set(leaves))
    unexpected = sorted(set(leaves) - set(state))
    if missing or unexpected:
        raise KeyError(f"flax_to_torch: names do not match; missing in the "
                       f"tree: {missing[:5]} ({len(missing)}), not in the "
                       f"module: {unexpected[:5]} ({len(unexpected)})")
    new = {}
    for name, t in state.items():
        a = leaves[name]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"flax_to_torch: {name} has shape {a.shape}, "
                             f"the module wants {tuple(t.shape)}")
        new[name] = torch.from_numpy(np.array(a, np.float32))
    module.load_state_dict(new, strict=True)
    return module
