"""The port's Inception-ResNet-v2 U-Net against the flax model, on one
variables tree.

The flax model runs the JAX engine's default inference forward
(``packed_heads=True``); the port runs its canonical form with every
decoder conv block on ``fused_conv3x3`` and, with ``fused_stages`` at
N == 1, the last stages on ``fused_up_stage`` (their plain versions on the
CPU).  BatchNorm statistics and biases are randomized before bridging.
Each JAX apply runs once per (model, dtype), jitted, at batch 2 and 64^2.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.lax as lax
import jax.numpy as jnp

torch.set_num_threads(2)

SIZE = 64
F32_TOL = 1e-4   # the DenseNet's bounds (test_torch_densenet_unet.py)
BF16_TOL = 0.03


@pytest.fixture(scope="module")
def irv2():
    """The randomized flax tree, a (2, 64, 64, 3) input, and a cache of
    JAX outputs by (dtype, fused_stages)."""
    from tests.torch_parity import model_variables, randomize

    v = randomize(model_variables("inception", SIZE, 0), 0)
    x = np.random.default_rng(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    return v, x, {}


def _plain_stage(y, ka, ba, ma, aa, kb, bb, mb, ab, skip=None):
    """The plain reference of JAX's ``fused_up_stage`` (as
    ``tests/test_stage_fused.py::canonical`` computes it) in y.dtype."""
    def conv(x, k):
        return lax.conv_general_dilated(
            x, k.astype(x.dtype), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)

    up = jnp.repeat(jnp.repeat(y, 2, axis=1), 2, axis=2)
    a = jnp.maximum((conv(up, ka) + ba) * ma + aa, 0.0).astype(y.dtype)
    b = a if skip is None else jnp.concatenate([a, skip], -1)
    return jnp.maximum((conv(b, kb) + bb) * mb + ab, 0.0).astype(y.dtype)


def _jax(irv2, dtype, fused_stages=0):
    """The JAX model's output, once per (dtype, fused_stages): the whole
    batch, or with fused_stages its first image alone, the last stages on
    the plain reference of the Pallas stage kernel."""
    from digipathai_tpu.models.registry import build_model

    v, x, cache = irv2
    key = (dtype, fused_stages)
    if key not in cache:
        b = build_model("inception", dtype=dtype, fused_stages=fused_stages)
        xs = x[:1] if fused_stages else x
        with mock.patch("digipathai_tpu.ops.pallas.stage_fused."
                        "fused_up_stage", _plain_stage):
            cache[key] = np.asarray(jax.jit(b.apply)(v, jnp.asarray(xs)))
    return cache[key]


def _torch(irv2, dtype, fused_stages=0, n=2):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    v, x, _ = irv2
    m = flax_to_torch(v, build_model("inception", dtype=dtype,
                                     fused_stages=fused_stages).module)
    with torch.inference_mode():
        return m(torch.from_numpy(x[:n])).numpy()


def test_f32_matches_jax(irv2):
    """Measured on this input with torch 2.13 (CPU): max|dp| 7.7e-7."""
    want = _jax(irv2, jnp.float32)
    got = _torch(irv2, torch.float32)
    assert got.shape == want.shape == (2, SIZE, SIZE, 2)
    assert want[..., 1].std() > 0.01  # the outputs are not saturated
    assert np.abs(got - want).max() <= F32_TOL


def test_bf16_matches_jax(irv2):
    """bf16: the encoder rounds where the JAX default rounds (folded branch
    BNs in bf16, flax BatchNorm in f32 with one rounding); the decoder's
    conv + bias rounds once, after the BN, in the fused kernel's epilogue
    (ROADMAP.md §C).  Measured on this input with torch 2.13 (CPU): max|dp|
    0.0052, mean 0.0009; bound 0.03."""
    want = _jax(irv2, jnp.bfloat16)
    got = _torch(irv2, torch.bfloat16)
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.max() <= BF16_TOL, (d.max(), d.mean())


@pytest.mark.parametrize("fused_stages", [0, 5])
def test_fused_stages_matches_jax(irv2, fused_stages):
    """At N == 1 the port's fused_stages run the last stages on
    fused_up_stage, against JAX's fused_stages=5 forward."""
    from digipathai_tpu_torch.ops import stage_fused

    want = _jax(irv2, jnp.float32, fused_stages=5)
    with mock.patch.object(stage_fused, "fused_up_stage",
                           wraps=stage_fused.fused_up_stage) as spy:
        got = _torch(irv2, torch.float32, fused_stages, n=1)
    assert spy.call_count == fused_stages
    assert got.shape == want.shape == (1, SIZE, SIZE, 2)
    assert np.abs(got - want).max() <= F32_TOL


def test_bridge_covers_every_name(irv2):
    """flax_to_torch is strict on names and shapes: a clean load means the
    port names its layers in KerasNamer's order, with no ``scale`` in the
    encoder's BatchNorms."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.inception_unet import \
        InceptionResNetV2UNet

    v = irv2[0]
    m = flax_to_torch(v, InceptionResNetV2UNet(dtype=torch.float32))
    assert len(m.state_dict()) == len(jax.tree_util.tree_leaves(v))
    p = v["params"]
    assert "scale" not in p["batch_normalization"]
    assert m.batch_normalization.scale is None
    assert m.conv_7b.kernel.shape == (1, 1, 2080, 1536)
    assert m.block35_1_conv.bias is not None
    # the decoder continues the encoder's counters
    first = m._blocks[0][0]
    assert first == "conv2d_203" and p[first]["kernel"].shape == (
        3, 3, 1536, 320)
    np.testing.assert_array_equal(m.conv2d_150.kernel.detach().numpy(),
                                  p["conv2d_150"]["kernel"])
    params = dict(p)
    del params["block17_7_conv"]
    with pytest.raises(KeyError, match="block17_7_conv"):
        flax_to_torch({"params": params, "batch_stats": v["batch_stats"]},
                      InceptionResNetV2UNet(dtype=torch.float32))


def test_kernel_calls_lists_the_forwards_kernel_calls(irv2):
    """``kernel_calls`` (the shapes chip_smoke.py measures) is the list of
    conv and stage calls a forward makes, in order: 10 conv blocks at
    N > 1, 5 stages and no conv with fused_stages=5 at N == 1."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.inception_unet import (
        InceptionResNetV2UNet, kernel_calls)
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    for n, fused in ((2, 0), (1, 5)):
        m = flax_to_torch(irv2[0], InceptionResNetV2UNet(
            dtype=torch.float32, fused_stages=fused))
        seen = []

        def conv(x, k, *a, **kw):
            seen.append(("conv", (*x.shape, k.f, k.pm is not None)))
            return conv_fused.fused_conv3x3_plain(x, k, *a, **kw)

        def stage(y, ka, *a, **kw):
            sk = a[-1]
            seen.append(("stage", (*y.shape, 0 if sk is None else
                                   sk.shape[-1], ka.f)))
            return stage_fused.fused_up_stage_plain(y, ka, *a, **kw)

        with mock.patch.object(conv_fused, "fused_conv3x3", conv), \
                mock.patch.object(stage_fused, "fused_up_stage", stage), \
                torch.inference_mode():
            m(torch.zeros(n, SIZE, SIZE, 3))
        want = [(k, s) for k, s, count in kernel_calls(n, SIZE, fused)
                for _ in range(count)]
        assert seen == want
        assert len(seen) == (10 if n > 1 else 5)
    # a 4352^2 tile: the three stage shapes the DenseNet has not
    stages = [s for k, s, _ in kernel_calls(1, 4352, 5) if k == "stage"]
    assert stages[:3] == [(1, 136, 136, 1536, 1088, 320),
                          (1, 272, 272, 320, 320, 256),
                          (1, 544, 544, 256, 192, 128)]


@pytest.mark.parametrize("side,stride", [(8, 2), (7, 2), (9, 1)])
def test_same_pad_matches_flax(side, stride):
    """``same_pad`` + a VALID conv is flax's SAME conv: (0, 1) at stride 2
    on an even side, (1, 1) on an odd one."""
    from digipathai_tpu_torch.models.unet_decoder import nchw, nhwc, same_pad

    rng = np.random.default_rng(side)
    x = rng.normal(size=(1, side, side, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = same_pad(torch.from_numpy(x), 3, 3, stride)
    got = nhwc(torch.nn.functional.conv2d(
        nchw(xt), torch.from_numpy(k).permute(3, 2, 0, 1), stride=stride))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
