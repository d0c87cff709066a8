"""Model registry (``digipathai_tpu/models/registry.py``).

All models map (B, P, P, 3) normalized NHWC patches to (B, P, P, 2) softmax
probabilities.  A bundle's "variables" are the module itself, with its
parameters: ``init`` fills them from a seed, ``apply`` runs the forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch.nn as nn


@dataclass
class ModelBundle:
    name: str
    module: nn.Module

    def init(self, patch_size: int = 256, seed: int = 0) -> nn.Module:
        """Seeded random parameters: flax's initializers, drawn for every
        Conv and BatchNorm of the module in registration order from one
        ``torch.Generator`` seeded with ``seed``.  ``patch_size`` is kept
        for signature parity: no parameter shape depends on it."""
        from .unet_decoder import init_params

        return init_params(self.module, seed).eval()

    def apply(self, variables: nn.Module, x):
        return variables(x)

    def apply_p1(self, variables: nn.Module, x):
        """p(class 1) as a (B, H, W) map: what the engine stitches."""
        return variables(x)[..., 1]


def _build_dense(**kw) -> ModelBundle:
    from .densenet_unet import DenseNet121UNet

    return ModelBundle("dense", DenseNet121UNet(**kw))


def _build_inception(**kw) -> ModelBundle:
    from .inception_unet import InceptionResNetV2UNet

    return ModelBundle("inception", InceptionResNetV2UNet(**kw))


def _build_deeplabv3(**kw) -> ModelBundle:
    from .deeplabv3 import DeepLabV3Plus

    return ModelBundle("deeplabv3", DeepLabV3Plus(**kw))


def _build_tiny(**kw) -> ModelBundle:
    from .tiny_unet import TinyUNet

    return ModelBundle("tiny", TinyUNet(**kw))


def _build_oracle(**kw) -> ModelBundle:
    from .oracle import OracleDarkness

    return ModelBundle("oracle", OracleDarkness(**kw))


# key order is the JAX registry's: substring dispatch resolves alike
_REGISTRY: Dict[str, Callable[..., ModelBundle]] = {
    "dense": _build_dense,
    "inception": _build_inception,
    "deeplabv3": _build_deeplabv3,
    "tiny": _build_tiny,
    "oracle": _build_oracle,
}


def available_models():
    return sorted(_REGISTRY)


def resolve_model_name(name: str) -> str:
    """Canonical registry key for ``name`` (substring dispatch)."""
    for key in _REGISTRY:
        if key in name:
            return key
    raise ValueError(
        f"Unknown model {name!r}, allowed models {available_models()}")


def build_model(name: str, **kw) -> ModelBundle:
    return _REGISTRY[resolve_model_name(name)](**kw)
