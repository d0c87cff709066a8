"""The port's DenseNet121-U-Net against the flax model, on one variables tree.

The flax model runs its default (chunked-encoder, canonical decoder)
forward; the port runs every 3x3 conv through ``fused_conv3x3`` (its plain
version on the CPU).  BatchNorm statistics and conv biases are randomized
before bridging, so every folded affine is exercised.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)


def _randomize(variables, seed):
    """numpy copy of a flax tree with random BN stats/affines and biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.array(a, np.float32)
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(leaf, variables)
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def dense_pair():
    """Flax variables for the full DenseNet121-U-Net at 64^2, randomized."""
    from digipathai_tpu.models.registry import build_model

    return _randomize(build_model("dense", dtype=jnp.float32).init(64), 0)


def _flax_probs(blocks, dtype, variables, x):
    from digipathai_tpu.models.densenet_unet import DenseNet121UNet

    m = DenseNet121UNet(blocks=blocks, dtype=dtype)
    return np.asarray(jax.jit(lambda v, x: m.apply(v, x, train=False))(
        variables, jnp.asarray(x)))


def _torch_probs(blocks, dtype, variables, x):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.densenet_unet import DenseNet121UNet

    m = flax_to_torch(variables, DenseNet121UNet(blocks=blocks, dtype=dtype))
    with torch.inference_mode():
        return m(torch.from_numpy(x)).numpy()


def _input(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def test_full_blocks_f32(dense_pair):
    x = _input(1)
    want = _flax_probs((6, 12, 24, 16), jnp.float32, dense_pair, x)
    got = _torch_probs((6, 12, 24, 16), torch.float32, dense_pair, x)
    assert got.shape == want.shape == (2, 64, 64, 2)
    assert np.abs(got - want).max() <= 1e-4


def test_short_blocks_f32():
    from digipathai_tpu.models.densenet_unet import DenseNet121UNet

    x = _input(2)
    blocks = (2, 2, 2, 2)
    m = DenseNet121UNet(blocks=blocks, dtype=jnp.float32)
    v = jax.jit(lambda k: m.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(3))
    v = _randomize(v, 4)
    want = _flax_probs(blocks, jnp.float32, v, x)
    got = _torch_probs(blocks, torch.float32, v, x)
    assert np.abs(got - want).max() <= 1e-4


def test_full_blocks_bf16(dense_pair):
    """bf16: both sides round activations to bf16, but at different places
    (ROADMAP.md §C, BatchNorm precision): flax's canonical BatchNorm and the
    port's stem/transition BNs compute in f32 and round once, while the
    decoder's conv + bias rounds to bf16 before its BN in flax and not in
    the fused kernel's epilogue.  Measured on this input with torch 2.13
    (CPU): max|dp| 0.0099, mean 0.0017; bound 0.03.  In f32 the same
    comparison measures max|dp| 2.3e-6 against its bound of 1e-4."""
    x = _input(5)
    want = _flax_probs((6, 12, 24, 16), jnp.bfloat16, dense_pair, x)
    got = _torch_probs((6, 12, 24, 16), torch.bfloat16, dense_pair, x)
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.max() <= 0.03, (d.max(), d.mean())


def test_bridge_covers_every_name(dense_pair):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.densenet_unet import DenseNet121UNet

    m = flax_to_torch(dense_pair, DenseNet121UNet(dtype=torch.float32))
    n_leaves = len(jax.tree_util.tree_leaves(dense_pair))
    assert n_leaves == len(m.state_dict())
    k = dense_pair["params"]["conv2d_5"]["kernel"]
    np.testing.assert_array_equal(m.conv2d_5.kernel.detach().numpy(), k)
    v = dense_pair["batch_stats"]["conv3_block2_1_bn"]["var"]
    np.testing.assert_array_equal(m.conv3_block2_1_bn.var.numpy(), v)

    params = dict(dense_pair["params"])
    del params["conv4_block7_2_conv"]
    with pytest.raises(KeyError, match="conv4_block7_2_conv"):
        flax_to_torch({"params": params,
                       "batch_stats": dense_pair["batch_stats"]},
                      DenseNet121UNet(dtype=torch.float32))
    params = dict(dense_pair["params"], extra_conv={"kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="extra_conv"):
        flax_to_torch({"params": params,
                       "batch_stats": dense_pair["batch_stats"]},
                      DenseNet121UNet(dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        flax_to_torch(dense_pair, DenseNet121UNet(growth=16,
                                                  dtype=torch.float32))


def test_random_init_matches_flax_statistics():
    """The seeded torch init draws flax's initializers: same shapes, BN at
    identity, zero biases, truncated-normal kernels of flax's variance."""
    from digipathai_tpu_torch.models.registry import build_model

    a = build_model("dense", dtype=torch.float32).init(256, seed=0)
    b = build_model("dense", dtype=torch.float32).init(256, seed=0)
    c = build_model("dense", dtype=torch.float32).init(256, seed=1)
    assert torch.equal(a.conv2d_3.kernel, b.conv2d_3.kernel)
    assert not torch.equal(a.conv2d_3.kernel, c.conv2d_3.kernel)
    k = a.conv2d_1.kernel  # he_normal: var 2 / fan_in
    fan_in = 9 * k.shape[2]
    assert abs(k.var().item() * fan_in / 2.0 - 1.0) < 0.05
    assert k.abs().max().item() <= 2 * (2.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(a.conv2d_1.bias, torch.zeros_like(a.conv2d_1.bias))
    assert torch.equal(a.bn.var, torch.ones_like(a.bn.var))
