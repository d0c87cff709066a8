"""Flax variable trees for the port's parity tests, from shapes alone.

Initialising a JAX model runs a whole forward (about 30 s on a CPU for the
DenseNet121-U-Net); the parity tests only need a tree of the right names
and shapes with sensible values, so they take the shapes from
``jax.eval_shape``, once per model and size in a process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _shapes(name: str, size: int, model_kw: tuple):
    """The shapes of ``build_model(name, **model_kw)``'s variables for a
    ``size``^2 input (tracing the model takes seconds; the shapes never
    change)."""
    from digipathai_tpu.models.registry import build_model

    module = build_model(name, dtype=jnp.float32, **dict(model_kw)).module
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    return jax.eval_shape(lambda k: module.init(k, x, train=False),
                          jax.random.PRNGKey(0))


def model_variables(name: str, size: int = 64, seed: int = 0, he=None,
                    **model_kw):
    """The variables tree of ``build_model(name, **model_kw)`` for a
    ``size``^2 input, as numpy arrays: conv kernels drawn N(0, scale /
    fan_in), scale 2 (he) where ``he(layer, leaves)`` says so and 1
    elsewhere, as the inits scale them; BatchNorm at identity and biases 0
    (``randomize`` draws those).  By default the he layers are the 3x3
    convs with a bias: the U-Net decoders' conv blocks."""
    shapes = _shapes(name, size, tuple(sorted(model_kw.items())))
    if he is None:
        def he(layer, leaves):
            return "bias" in leaves and leaves["kernel"].shape[:2] == (3, 3)
    he_layers = {layer for layer, leaves in shapes["params"].items()
                 if "kernel" in leaves and he(layer, leaves)}
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, layer = path[-1].key, path[-2].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            scale = 2.0 if layer in he_layers else 1.0
            return (rng.standard_normal(s.shape)
                    * np.sqrt(scale / fan_in)).astype(np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(s.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def dense_variables(size: int = 64, seed: int = 0, **model_kw):
    """``model_variables("dense", ...)`` with scale 2 for every ``conv2d*``
    layer (the decoder and its head)."""
    return model_variables("dense", size, seed,
                           he=lambda layer, _: layer.startswith("conv2d"),
                           **model_kw)


def randomize(variables, seed: int):
    """numpy copy of a flax tree with random BN statistics and affines and
    random biases, so every folded affine is exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map(
        np.asarray, dict(jax.tree_util.tree_map_with_path(leaf, variables)))
