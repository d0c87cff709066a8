"""BatchNorm folding for inference (``getSegmentation(fold_bn=True)``).

A numpy copy of ``digipathai_tpu/models/fold_bn.py``.  Each conv -> BN
pair folds into a scaled conv and a pure shift: with ``s = gamma /
sqrt(var + eps)`` the kernel's output channels are scaled by ``s`` and the
BN becomes the identity plus a bias (scale 1, mean 0, var 1 - eps, bias
``beta - mu * s`` [+ old conv bias * s]).  The module's graph is
untouched, and the transform is exact up to float reassociation.

Pairing rules, for all three model families:

- named pairs: ``X`` -> ``X_bn`` / ``X_BN`` (Inception's conv_7b, every
  DeepLab conv) and ``conv1__conv`` -> ``conv1__bn`` (the DenseNet stem);
- Keras auto-named pairs: ``conv2d[_k]`` -> ``batch_normalization[_k]``
  (every unnamed conv with a BN is created just before its unnamed BN).

DenseNet's pre-activation BNs (BN -> relu -> conv) are not after a conv and
stay as they are.  ``fold_module`` folds a module's own state in place;
its prepared kernel operands are rebuilt on the next forward, because
loading the state bumps each parameter's version.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["fold_batchnorm", "fold_module"]


def _bn_eps(bn_name: str) -> float:
    # DeepLab's ASPP and decoder BNs use 1e-5, the DenseNet stem 1.001e-5,
    # everything else folded the Keras default 1e-3
    if bn_name.endswith("_BN") and any(k in bn_name for k in (
            "image_pooling", "aspp", "concat_projection",
            "feature_projection", "decoder_conv")):
        return 1e-5
    if bn_name == "conv1__bn":
        return 1.001e-5
    return 1e-3


def _candidates(conv_name: str):
    out = [conv_name + "_bn", conv_name + "_BN"]
    if conv_name.endswith("__conv"):
        out.append(conv_name[:-len("__conv")] + "__bn")
    if conv_name == "conv2d" or conv_name.startswith("conv2d_"):
        suffix = conv_name[len("conv2d"):]
        out.append("batch_normalization" + suffix)
    return out


def fold_batchnorm(variables: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """(folded copy of the numpy variables tree, number of folded pairs)."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    stats = {k: dict(v) for k, v in variables.get("batch_stats", {}).items()}
    n = 0
    for conv_name, conv_p in params.items():
        if "kernel" not in conv_p:
            continue
        bn_name = next((c for c in _candidates(conv_name)
                        if c in stats and c in params), None)
        if bn_name is None:
            continue
        bn_p = params[bn_name]
        bn_s = stats[bn_name]
        eps = _bn_eps(bn_name)
        gamma = np.asarray(bn_p.get("scale", 1.0), np.float32)
        beta = np.asarray(bn_p.get("bias", 0.0), np.float32)
        mu = np.asarray(bn_s["mean"], np.float32)
        var = np.asarray(bn_s["var"], np.float32)
        s = gamma / np.sqrt(var + eps)

        kernel = np.asarray(conv_p["kernel"], np.float32)
        conv_p["kernel"] = (kernel * s).astype(np.asarray(conv_p["kernel"]).dtype)
        shift = beta - mu * s
        if "bias" in conv_p:
            shift = shift + np.asarray(conv_p["bias"], np.float32) * s
            conv_p["bias"] = np.zeros_like(np.asarray(conv_p["bias"]))
        # the BN becomes the identity plus the shift
        if "scale" in bn_p:
            bn_p["scale"] = np.ones_like(gamma)
        bn_p["bias"] = shift.astype(np.asarray(beta).dtype)
        bn_s["mean"] = np.zeros_like(mu)
        bn_s["var"] = np.full_like(var, 1.0 - eps)
        n += 1

    out = dict(variables)
    out["params"] = params
    if stats:
        out["batch_stats"] = stats
    return out, n


def fold_module(module) -> int:
    """Fold ``module``'s conv -> BN pairs in place; returns their number.
    A module without BatchNorm statistics is left as it is."""
    from .bridge import flax_to_torch, torch_to_flax

    tree = torch_to_flax(module)
    if "batch_stats" not in tree:
        return 0
    folded, n = fold_batchnorm(tree)
    flax_to_torch(folded, module)
    return n
