"""The port's DenseNet121-U-Net against the flax model, on one variables tree.

The flax model runs its default (chunked-encoder, canonical decoder)
forward; the port runs every 3x3 conv through ``fused_conv3x3`` (its plain
version on the CPU).  BatchNorm statistics and conv biases are randomized
before bridging, so every folded affine is exercised.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import randomize

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dense_pair():
    """Flax variables for the full DenseNet121-U-Net at 64^2, randomized."""
    from tests.torch_parity import dense_variables

    return randomize(dense_variables(64, 0), 0)


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
    v = randomize(v, 4)
    want = _flax_probs(blocks, jnp.float32, v, x)
    got = _torch_probs(blocks, torch.float32, v, x)
    assert np.abs(got - want).max() <= 1e-4


def test_full_blocks_bf16(dense_pair):
    """bf16: both sides round activations to bf16, but at different places
    (ROADMAP.md §C, BatchNorm precision): flax's canonical BatchNorm and the
    port's stem/transition BNs compute in f32 and round once, while the
    decoder's conv + bias rounds to bf16 before its BN in flax and not in
    the fused kernel's epilogue.  Measured on this input with torch 2.13
    (CPU): max|dp| 0.0125, mean 0.0021; bound 0.03.  In f32 the same
    comparison measures max|dp| 2.7e-6 against its bound of 1e-4."""
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


def _small(seed, fused_stages=0, dtype=torch.float32):
    from digipathai_tpu_torch.models.densenet_unet import (DenseNet121UNet,
                                                           init_params)

    m = init_params(DenseNet121UNet(blocks=(2, 2, 2, 2), dtype=dtype,
                                    fused_stages=fused_stages), seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():  # BN statistics away from identity
        for name, t in m.state_dict().items():
            if name.endswith(("scale", "var")):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("bn.bias", "mean")) or "bn" in name and \
                    name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return m


def _cached_tensors(ops):
    """Every tensor of a cache entry: the folded BN0 pair, one conv's
    ``ConvOperands`` or a stage's two."""
    from digipathai_tpu_torch.ops.conv_fused import ConvOperands

    if isinstance(ops, torch.Tensor):
        return [ops]
    if isinstance(ops, ConvOperands):
        return [t for t in (ops.w, ops.mul, ops.off, ops.pm, ops.pa)
                if t is not None]
    return [t for o in ops for t in _cached_tensors(o)]


def _bn_name(name):
    return "bn" in name or "batch_normalization" in name


@pytest.mark.parametrize("how", ["flax_to_torch", "in_place", "bn_only",
                                 "kernels_only"])
def test_weights_changed_after_a_forward_take_effect(how):
    """The model caches the operands it prepares from its parameters (the
    folded BN0, each conv's packed bf16 kernel, folded affine and
    pre-affine, each fused stage's two); weights loaded, or edited in place,
    after a first forward give a fresh model's output, and every cached
    operand equals the one a fresh model prepares.  Editing the BN tensors
    alone, or the conv kernels alone, shows that each enters every stamp it
    should."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch

    x = torch.from_numpy(_input(7)[:1])
    m, other = (_small(s, fused_stages=2, dtype=torch.bfloat16)
                for s in (0, 1))
    with torch.inference_mode():
        before = m(x)
    assert any(k.startswith("stage") for k in m._prepared)
    if how == "flax_to_torch":
        tree = {}
        for name, t in other.state_dict().items():
            layer, leaf = name.rsplit(".", 1)
            coll = "batch_stats" if leaf in ("mean", "var") else "params"
            tree.setdefault(coll, {}).setdefault(layer, {})[leaf] = t.numpy()
        flax_to_torch(tree, m)
    else:
        keep = {"in_place": lambda n: False, "bn_only": lambda n: not
                _bn_name(n), "kernels_only": lambda n: not n.endswith(
                    "kernel")}[how]
        with torch.no_grad():
            for (name, a), b in zip(m.state_dict().items(),
                                    other.state_dict().values()):
                if not keep(name):
                    a.copy_(b)
    fresh = _small(0, fused_stages=2, dtype=torch.bfloat16)
    fresh.load_state_dict(m.state_dict())
    with torch.inference_mode():
        after, want = m(x), fresh(x)
    assert not torch.equal(before, want)
    assert torch.equal(after, want)
    assert m._prepared.keys() == fresh._prepared.keys()
    for key, (_, ops) in m._prepared.items():
        got, new = _cached_tensors(ops), _cached_tensors(fresh._prepared[key][1])
        assert len(got) == len(new) and all(
            torch.equal(a, b) for a, b in zip(got, new)), key


def test_kernel_calls_lists_the_forwards_kernel_calls():
    """``kernel_calls`` (the shapes chip_smoke.py measures) is the list of
    conv and stage calls a forward makes, in order."""
    from digipathai_tpu_torch.models.densenet_unet import kernel_calls
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    for n, fused in ((2, 0), (1, 2)):
        m = _small(0, fused_stages=fused)
        seen = []

        def conv(x, k, *a, **kw):  # k: the conv's ConvOperands
            seen.append(("conv", (*x.shape, k.f, k.pm is not None)))
            return conv_fused.fused_conv3x3_plain(x, k, *a, **kw)

        def stage(y, ka, *a, skip=None, **kw):
            sk = a[-1] if len(a) == 8 else skip
            seen.append(("stage", (*y.shape, 0 if sk is None else
                                   sk.shape[-1], ka.f)))
            return stage_fused.fused_up_stage_plain(y, ka, *a, **kw)

        with mock.patch.object(conv_fused, "fused_conv3x3", conv), \
                mock.patch.object(stage_fused, "fused_up_stage", stage), \
                torch.inference_mode():
            m(torch.zeros(n, 64, 64, 3))
        want = [(k, s) for k, s, count in
                kernel_calls(n, 64, fused, blocks=(2, 2, 2, 2))
                for _ in range(count)]
        assert seen == want
