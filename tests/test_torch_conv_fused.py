"""The port's fused_conv3x3 (plain path on the CPU) against the JAX Pallas
kernel in interpret mode, at the shapes of tests/test_conv_fused.py.

The CUDA kernel itself has no interpret mode; chip_smoke.py compares it with
the plain version on the card.  Here the wrapper's CPU dispatch and its
refusal to fall back for a CUDA tensor are checked.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

TOL = 2e-4  # the bound of tests/test_conv_fused.py


def _inputs(n, h, w, c, f, seed, pre):
    rng = np.random.default_rng(seed)
    d = {"x": rng.normal(0, 1, (n, h, w, c)).astype(np.float32),
         "k": rng.normal(0, 0.2, (3, 3, c, f)).astype(np.float32)}
    if pre:
        d["pre_mul"] = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
        # strictly positive offsets: the border-leak case
        d["pre_add"] = rng.uniform(0.1, 0.5, (c,)).astype(np.float32)
    else:
        d["bias"] = rng.normal(0, 0.1, (f,)).astype(np.float32)
        d["mul"] = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
        d["add"] = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return d


def _jax(d, relu, **kw):
    """JAX kernel, one N=1 call per image (it asserts N == 1)."""
    from digipathai_tpu.ops.pallas.conv_fused import fused_conv3x3

    args = {k: jnp.asarray(v) for k, v in d.items() if k not in ("x", "k")}
    outs = [np.asarray(fused_conv3x3(jnp.asarray(d["x"][i:i + 1]),
                                     jnp.asarray(d["k"]), relu=relu,
                                     interpret=True, **args, **kw))
            for i in range(d["x"].shape[0])]
    return np.concatenate(outs)


def _torch(d, relu):
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return fused_conv3x3(t.pop("x"), t.pop("k"), relu=relu, **t).numpy()


@pytest.mark.parametrize("n,h,w,c,f,pre,relu", [
    (1, 12, 24, 5, 7, False, True),
    (1, 8, 512, 64, 64, False, True),
    (1, 12, 24, 5, 7, True, False),
    (1, 40, 300, 128, 32, True, False),
    (3, 12, 24, 5, 7, True, True),      # N=3 against three N=1 calls
    (3, 9, 17, 16, 24, False, False),
])
def test_matches_pallas_kernel(n, h, w, c, f, pre, relu):
    d = _inputs(n, h, w, c, f, seed=h + c + f, pre=pre)
    want = _jax(d, relu, block_rows=4, block_cols=128)
    got = _torch(d, relu)
    assert got.shape == (n, h, w, f)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_no_affine_no_relu():
    rng = np.random.default_rng(0)
    d = {"x": rng.normal(0, 1, (1, 8, 16, 3)).astype(np.float32),
         "k": rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32)}
    want = _jax(d, False, block_rows=4, block_cols=16)
    np.testing.assert_allclose(_torch(d, False), want, rtol=TOL, atol=TOL)


def test_bf16_pre_activation_rounds_like_jax():
    """bf16: x * pre_mul and + pre_add each round to bf16 on both sides."""
    d = _inputs(1, 8, 16, 16, 8, seed=9, pre=True)
    xb = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    from digipathai_tpu.ops.pallas.conv_fused import fused_conv3x3 as jf
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3 as tf

    want = np.asarray(jf(xb, jnp.asarray(d["k"]), relu=False,
                         pre_mul=jnp.asarray(d["pre_mul"]),
                         pre_add=jnp.asarray(d["pre_add"]),
                         block_rows=4, block_cols=16,
                         interpret=True).astype(jnp.float32))
    got = tf(torch.from_numpy(d["x"]).bfloat16(), torch.from_numpy(d["k"]),
             relu=False, pre_mul=torch.from_numpy(d["pre_mul"]),
             pre_add=torch.from_numpy(d["pre_add"])).float().numpy()
    # one bf16 rounding of the output (2^-8 relative) apart at most, plus
    # the f32 summation order
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_cuda_tensor_without_kernel_raises(monkeypatch):
    """A CUDA tensor never takes the plain path: with no kernel available
    the call raises.  Without a GPU, a stand-in object carries a CUDA device
    and the build is pointed at a missing nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel is available here")
    from digipathai_tpu_torch import _build
    from digipathai_tpu_torch.ops import conv_fused

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "missing.so")
    _build.load.cache_clear()
    calls = []
    monkeypatch.setattr(conv_fused, "fused_conv3x3_plain",
                        lambda *a, **k: calls.append(1))
    fake = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dtype=torch.bfloat16, shape=(1, 4, 4, 8),
                                 dim=lambda: 4, is_contiguous=lambda: True)
    before = conv_fused.fused_conv3x3.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        conv_fused.fused_conv3x3(fake, torch.zeros(3, 3, 8, 8))
    assert calls == [] and conv_fused.fused_conv3x3.launches == before
    _build.load.cache_clear()


def test_other_devices_raise():
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3

    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv3x3(x, torch.zeros(3, 3, 8, 8))
