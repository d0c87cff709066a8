"""The port's DeepLabv3+ (Xception-65, output stride 16) against the flax
model on one variables tree, and its align-corners resize against JAX's.

BatchNorm statistics and biases are randomized before bridging, and the
logits layer is scaled up so that the class probabilities spread over a
useful range.  Each JAX apply runs once, jitted: batch 2 at 64^2 in f32
and bf16, and the windowed image pooling (``aspp_pool_window=64``) at
128^2 in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_TOL = 0.03


@pytest.fixture(scope="module")
def xception():
    """The randomized flax tree (no parameter shape depends on the input
    size), inputs at 64^2 and 128^2, and a cache of JAX outputs."""
    from tests.torch_parity import model_variables, randomize

    v = randomize(model_variables("deeplabv3", 64, 0), 0)
    v["params"]["custom_logits_semantic"]["kernel"] *= 20.0
    rng = np.random.default_rng(1)
    xs = {s: rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
          for s in (64, 128)}
    return v, xs, {}


def _jax(xception, dtype, size=64, window=0):
    from digipathai_tpu.models.registry import build_model

    v, xs, cache = xception
    key = (dtype, size, window)
    if key not in cache:
        b = build_model("deeplabv3", dtype=dtype, aspp_pool_window=window)
        cache[key] = np.asarray(jax.jit(b.apply)(v, jnp.asarray(xs[size])))
    return cache[key]


def _torch_model(xception, dtype, window=0):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    return flax_to_torch(xception[0], build_model(
        "deeplabv3", dtype=dtype, aspp_pool_window=window).module)


def _torch(xception, dtype, size=64, window=0):
    m = _torch_model(xception, dtype, window)
    with torch.inference_mode():
        return m(torch.from_numpy(xception[1][size])).numpy()


def test_f32_matches_jax(xception):
    """Measured on this input with torch 2.13 (CPU): max|dp| 9.5e-7."""
    want = _jax(xception, jnp.float32)
    got = _torch(xception, torch.float32)
    assert got.shape == want.shape == (2, 64, 64, 2)
    assert want[..., 1].std() > 0.05  # the outputs are not saturated
    assert np.abs(got - want).max() <= F32_TOL


def test_bf16_matches_jax(xception):
    """bf16: each conv rounds to bf16 and each BatchNorm computes in f32
    and rounds once, on both sides; XLA may keep an elementwise chain in
    f32 where the port rounds after each op, and the logits scaled 20x
    scale those differences up.  Measured on this input with torch 2.13
    (CPU): max|dp| 0.0164, mean 0.0024; bound 0.03, as for the U-Nets."""
    want = _jax(xception, jnp.bfloat16)
    got = _torch(xception, torch.bfloat16)
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.max() <= BF16_TOL, (d.max(), d.mean())


def test_aspp_pool_window_matches_jax(xception):
    """Windowed image pooling (tile mode's ``tile_local_aspp``): 64 px
    windows of a 128^2 input, 4x4 blocks of its 8x8 features.  It differs
    from the global pool, and the port follows JAX's windowed model
    (measured max|dp| 2.7e-6)."""
    want = _jax(xception, jnp.float32, size=128, window=64)
    got = _torch(xception, torch.float32, size=128, window=64)
    assert got.shape == want.shape == (2, 128, 128, 2)
    assert np.abs(got - want).max() <= F32_TOL
    glob = _torch(xception, torch.float32, size=128)
    assert np.abs(glob - got).max() > 10 * F32_TOL


def test_aspp_pool_window_must_divide_the_features(xception):
    """As in JAX: a window that does not divide the features raises."""
    from digipathai_tpu.models.registry import build_model

    b = build_model("deeplabv3", dtype=jnp.float32, aspp_pool_window=48)
    x = jnp.zeros((1, 64, 64, 3))  # features 4x4, window 3x3
    with pytest.raises(ValueError, match="aspp_pool_window 48"):
        jax.eval_shape(b.apply, xception[0], x)
    m = _torch_model(xception, torch.float32, window=48)
    with pytest.raises(ValueError, match="aspp_pool_window 48"):
        with torch.inference_mode():
            m(torch.zeros(1, 64, 64, 3))


def test_bridge_covers_every_name(xception):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.deeplabv3 import DeepLabV3Plus

    v = xception[0]
    m = flax_to_torch(v, DeepLabV3Plus(dtype=torch.float32))
    assert len(m.state_dict()) == len(jax.tree_util.tree_leaves(v))
    # depthwise kernels keep flax's (3, 3, 1, C)
    k = v["params"]["middle_flow_unit_7_separable_conv2_depthwise"]["kernel"]
    assert k.shape == (3, 3, 1, 728)
    np.testing.assert_array_equal(
        m.middle_flow_unit_7_separable_conv2_depthwise.kernel.detach()
        .numpy(), k)
    params = dict(v["params"])
    del params["aspp2_pointwise"]
    with pytest.raises(KeyError, match="aspp2_pointwise"):
        flax_to_torch({"params": params, "batch_stats": v["batch_stats"]},
                      DeepLabV3Plus(dtype=torch.float32))


@pytest.mark.parametrize("shape,out", [
    ((2, 4, 4, 3), (16, 16)),   # x4, as the decoder upsamples
    ((1, 7, 5, 2), (28, 20)),
    ((2, 1, 1, 4), (8, 8)),     # the image-pooling branch, from 1x1
    ((1, 16, 16, 1), (4, 4)),   # down
    ((2, 5, 9), (20, 36)),      # rank 3: a (B, H, W) map
    ((1, 6, 6), (6, 6)),
])
def test_resize_matches_jax(shape, out):
    from digipathai_tpu.ops.resize import resize_bilinear_align_corners as jr
    from digipathai_tpu_torch.ops.resize import \
        resize_bilinear_align_corners as tr

    x = np.random.default_rng(len(shape) + out[0]).normal(
        size=shape).astype(np.float32)
    want = np.asarray(jr(jnp.asarray(x), out))
    got = tr(torch.from_numpy(x), out)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # bf16: f32 arithmetic and one rounding, back in the input's dtype
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = np.asarray(jr(xb, out).astype(jnp.float32))
    gb = tr(torch.from_numpy(x).to(torch.bfloat16), out)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), wb, rtol=2 ** -8,
                               atol=1e-6)
