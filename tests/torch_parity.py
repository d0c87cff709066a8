"""Flax variable trees for the port's parity tests, from shapes alone.

Initialising the JAX DenseNet121-U-Net runs a whole forward (about 30 s on
a CPU); the parity tests only need a tree of the right names and shapes
with sensible values, so they take the shapes from ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np


def dense_variables(size: int = 64, seed: int = 0, **model_kw):
    """The variables tree of ``build_model("dense", **model_kw)`` for a
    ``size``^2 input, as numpy arrays: conv kernels drawn N(0, scale /
    fan_in), scale 2 in the decoder (``conv2d*``) and 1 elsewhere, as the
    inits scale them; BatchNorm at identity and biases 0 (the tests
    randomize those)."""
    from digipathai_tpu.models.registry import build_model

    module = build_model("dense", dtype=jnp.float32, **model_kw).module
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: module.init(k, x, train=False),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, layer = path[-1].key, path[-2].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            scale = 2.0 if layer.startswith("conv2d") else 1.0
            return (rng.standard_normal(s.shape)
                    * np.sqrt(scale / fan_in)).astype(np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(s.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
