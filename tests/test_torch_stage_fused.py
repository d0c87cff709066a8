"""The port's fused_up_stage (plain path on the CPU) against the JAX Pallas
kernel in interpret mode, and the DenseNet121-U-Net with fused_stages.

The CUDA kernel itself has no interpret mode; chip_smoke.py compares it with
the plain version on the card.  Here the wrapper's checks, its CPU dispatch
and its refusal to fall back for a CUDA tensor are tested.
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import randomize

torch.set_num_threads(2)

F32_TOL = 1e-4      # the bound of tests/test_stage_fused.py
BF16_REL = 2 ** -6  # of max(1, max|ref|): a few bf16 roundings apart

# (hh, wh, c, cs, f, relu): the shapes of tests/test_stage_fused.py, with
# and without a skip, and its no-relu case
SHAPES = [(8, 12, 5, 3, 7, True), (16, 16, 8, 0, 6, True),
          (10, 18, 3, 4, 5, True), (6, 6, 4, 2, 5, False)]
NAMES = ("y", "ka", "ba", "ma", "aa", "kb", "bb", "mb", "ab", "skip")


def _stage(seed, hh, wh, c, cs, f, n=1):
    """numpy inputs as tests/test_stage_fused.py draws them."""
    rng = np.random.default_rng(seed)
    d = {"y": rng.normal(0, 1, (n, hh, wh, c)),
         "ka": rng.normal(0, 0.3, (3, 3, c, f)),
         "kb": rng.normal(0, 0.3, (3, 3, f + cs, f)),
         "ba": rng.normal(0, 0.1, (f,)), "bb": rng.normal(0, 0.1, (f,)),
         "ma": rng.uniform(0.5, 1.5, (f,)), "mb": rng.uniform(0.5, 1.5, (f,)),
         "aa": rng.normal(0, 0.1, (f,)), "ab": rng.normal(0, 0.1, (f,)),
         "skip": rng.normal(0, 1, (n, 2 * hh, 2 * wh, cs)) if cs else None}
    return {k: None if v is None else v.astype(np.float32)
            for k, v in d.items()}


def _jax(d, relu, dtype):
    from digipathai_tpu.ops.pallas.stage_fused import fused_up_stage

    a = [None if d[k] is None else jnp.asarray(d[k]) for k in NAMES]
    a[0] = a[0].astype(dtype)
    if a[9] is not None:
        a[9] = a[9].astype(dtype)
    out = fused_up_stage(*a, relu=relu, block_rows=4, block_cols=32,
                         interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _args(d, dtype):
    a = [None if d[k] is None else torch.from_numpy(d[k]) for k in NAMES]
    a[0] = a[0].to(dtype)
    if a[9] is not None:
        a[9] = a[9].to(dtype)
    return a


def _torch(d, relu, dtype):
    from digipathai_tpu_torch.ops.stage_fused import fused_up_stage

    return fused_up_stage(*_args(d, dtype), relu=relu).float().numpy()


def _folded(d, relu, dtype):
    """The stage's plain version with convA on folded taps, as the kernel
    runs it."""
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3_plain
    from digipathai_tpu_torch.ops.stage_fused import conv_up_folded_plain

    y, ka, ba, ma, aa, kb, bb, mb, ab, skip = _args(d, dtype)
    a = conv_up_folded_plain(y, ka, ba, ma, aa, relu=relu)
    x = a if skip is None else torch.cat([a, skip], dim=-1)
    return fused_conv3x3_plain(x, kb, bb, mb, ab,
                               relu=relu).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_f32(shape):
    hh, wh, c, cs, f, relu = shape
    d = _stage(hh * 31 + c, hh, wh, c, cs, f)
    want = _jax(d, relu, jnp.float32)
    got = _torch(d, relu, torch.float32)
    assert got.shape == (1, 2 * hh, 2 * wh, f)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_folded(d, relu, torch.float32), want,
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_bf16(shape):
    """bf16: both round ``a`` and the output once, but JAX pre-sums the
    duplicated row taps of ka before its bf16 cast and the plain version
    rounds each conv to bf16 before its affine."""
    hh, wh, c, cs, f, relu = shape
    d = _stage(hh * 31 + c, hh, wh, c, cs, f)
    want = _jax(d, relu, jnp.bfloat16)
    for got in (_torch(d, relu, torch.bfloat16),
                _folded(d, relu, torch.bfloat16)):
        err = np.abs(got - want).max()
        assert err <= BF16_REL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("shape", SHAPES + [(7, 9, 6, 5, 10, True)])
def test_folded_conv_a_matches_unfolded_f32(shape):
    """convA on the four folded 2x2 parity kernels equals the 3x3 conv over
    the upsampled y in f32 (only the summation order differs), N = 3 and
    odd Hh, Wh included: every SAME border of every parity class."""
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3_plain
    from digipathai_tpu_torch.ops.stage_fused import (conv_up_folded_plain,
                                                      upsample2x)

    hh, wh, c, cs, f, relu = shape
    d = _stage(hh + 7 * c, hh, wh, c, cs, f, n=3)
    y, ka = torch.from_numpy(d["y"]), torch.from_numpy(d["ka"])
    vec = [torch.from_numpy(d[k]) for k in ("ba", "ma", "aa")]
    want = fused_conv3x3_plain(upsample2x(y), ka, *vec, relu=relu)
    got = conv_up_folded_plain(y, ka, *vec, relu=relu)
    assert got.shape == (3, 2 * hh, 2 * wh, f)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fold_upsample_kernel_sums_rows_then_columns():
    from digipathai_tpu_torch.ops.stage_fused import fold_upsample_kernel

    k = torch.arange(9.0).reshape(3, 3, 1, 1)
    kf = fold_upsample_kernel(k)[..., 0, 0]
    # rows [k0, k1 + k2] / [k0 + k1, k2], then the columns alike
    np.testing.assert_array_equal(kf[0].numpy(), [[0, 3], [9, 24]])
    np.testing.assert_array_equal(kf[3].numpy(), [[8, 7], [13, 8]])
    assert kf.sum(dim=(1, 2)).tolist() == [36.0] * 4


def test_prepared_operands_run_the_plain_path_on_their_raw_params():
    """On a CPU tensor the wrappers take prepared operands (as the model
    passes them) and run the plain version on their raw parameters, as the
    plain versions do when chip_smoke.py swaps prepared operands in; operands
    prepared for another device or dtype are refused."""
    from digipathai_tpu_torch.ops.conv_fused import (fused_conv3x3,
                                                      fused_conv3x3_plain,
                                                      prepare)
    from digipathai_tpu_torch.ops.stage_fused import (fused_up_stage,
                                                      fused_up_stage_plain,
                                                      prepare_stage)

    d = _stage(5, 4, 6, 8, 8, 16)
    a = _args(d, torch.float32)
    opa, opb = prepare_stage(*a[1:9], dtype=torch.float32, device="cpu")
    want = fused_up_stage_plain(*a, relu=True)
    for fn in (fused_up_stage_plain, fused_up_stage):
        got = fn(a[0], opa, None, None, None, opb, None, None, None, a[9],
                 relu=True)
        assert torch.equal(got, want)
    x, k = a[0], a[1]
    ops = prepare(k, *a[2:5], pre_mul=a[3][:8], pre_add=a[4][:8],
                  dtype=torch.float32, device="cpu")
    want = fused_conv3x3_plain(x, k, *a[2:5], pre_mul=a[3][:8],
                               pre_add=a[4][:8])
    assert torch.equal(fused_conv3x3(x, ops), want)
    with pytest.raises(ValueError, match="prepared"):
        fused_conv3x3(x.bfloat16(), ops)
    meta = prepare(k, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="prepared"):
        fused_conv3x3(x, meta)
    meta_a, meta_b = prepare_stage(*a[1:9], dtype=torch.float32,
                                   device="meta")
    with pytest.raises(ValueError, match="prepared"):
        fused_up_stage(a[0], meta_a, None, None, None, meta_b, None, None,
                       None, a[9])


# the stages of Inception's 4352^2 tile forward that the DenseNet does not
# have (stages 4 and 5 are the DenseNet's): (hh, wh, c, cs, f)
INCEPTION_STAGES = [(136, 136, 1536, 1088, 320), (272, 272, 320, 320, 256),
                    (544, 544, 256, 192, 128)]


@pytest.mark.parametrize("stage", INCEPTION_STAGES)
def test_inception_stage_shapes_plan_and_run(stage):
    """Inception's new stage shapes take the wgmma path for both convs (the
    full coverage check of each plan is in test_torch_conv_fused.py), need
    a split-K scratch only where K is split, and at their channel widths
    the prepared stage on a small grid equals the plain version on its raw
    parameters, with convA on folded taps as the kernel runs it."""
    from digipathai_tpu_torch.ops.stage_fused import (fused_up_stage,
                                                      prepare_stage, scratch,
                                                      stage_plans)

    hh, wh, c, cs, f = stage
    plans = stage_plans(1, hh, wh, c, cs, f, torch.bfloat16)
    assert all(p.vector for p in plans)
    assert plans[0].chunks * plans[0].bk >= c
    assert plans[1].chunks * plans[1].bk >= f + cs
    part = scratch(plans, 4 * hh * wh, f, "meta")
    assert (part is None) == all(p.splits == 1 for p in plans)
    d = _stage(c + cs, 3, 4, c, cs, f)
    d["ka"] /= np.float32(np.sqrt(c))  # unit-scale activations at any width
    d["kb"] /= np.float32(np.sqrt(f + cs))
    a = _args(d, torch.float32)
    opa, opb = prepare_stage(*a[1:9], dtype=torch.float32, device="cpu")
    got = fused_up_stage(a[0], opa, None, None, None, opb, None, None, None,
                         a[9]).numpy()
    np.testing.assert_allclose(got, _folded(d, True, torch.float32),
                               rtol=F32_TOL, atol=F32_TOL)


def test_batch_matches_single_images():
    """N = 3 in one call equals three N = 1 calls (the kernel takes N >= 1
    though the model calls it at N = 1 only)."""
    d = _stage(3, 5, 7, 6, 4, 8, n=3)
    got = _torch(d, True, torch.float32)
    for i in range(3):
        di = dict(d, y=d["y"][i:i + 1], skip=d["skip"][i:i + 1])
        np.testing.assert_allclose(got[i:i + 1], _jax(di, True, jnp.float32),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bad,match", [
    ({"ka": np.zeros((3, 3, 4, 7), np.float32)}, "ka shape"),
    ({"kb": np.zeros((3, 3, 7, 7), np.float32)}, "kb shape"),
    ({"skip": np.zeros((1, 16, 22, 3), np.float32)}, "skip shape"),
    ({"mb": np.zeros((6,), np.float32)}, "mulb shape"),
])
def test_bad_shapes_raise(bad, match):
    d = {**_stage(0, 8, 12, 5, 3, 7), **bad}
    with pytest.raises(ValueError, match=match):
        _torch(d, True, torch.float32)


def test_cuda_tensor_without_kernel_raises(monkeypatch):
    """A CUDA tensor never takes the plain path: with no kernel available
    the call raises.  Without a GPU, stand-in objects carry a CUDA device
    and the build is pointed at a missing nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel is available here")
    from digipathai_tpu_torch import _build
    from digipathai_tpu_torch.ops import stage_fused

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "missing.so")
    _build.load.cache_clear()
    calls = []
    monkeypatch.setattr(stage_fused, "fused_up_stage_plain",
                        lambda *a, **k: calls.append(1))
    cuda = torch.device("cuda", 0)
    y = types.SimpleNamespace(device=cuda, dtype=torch.bfloat16,
                              shape=(1, 4, 4, 8), dim=lambda: 4)
    skip = types.SimpleNamespace(device=cuda, shape=(1, 8, 8, 8),
                                 dim=lambda: 4)
    before = stage_fused.fused_up_stage.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        stage_fused.fused_up_stage(y, torch.zeros(3, 3, 8, 16), None, None,
                                   None, torch.zeros(3, 3, 24, 16), None,
                                   None, None, skip)
    assert calls == [] and stage_fused.fused_up_stage.launches == before
    _build.load.cache_clear()


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def dense_fused():
    """One randomized flax tree, one 64^2 input and ONE JAX apply of
    ``build_model("dense", fused_stages=5)`` (Pallas in interpret mode),
    jitted: the same output as the eager apply in well under half its
    time."""
    from digipathai_tpu.models.registry import build_model

    from tests.torch_parity import dense_variables

    b = build_model("dense", dtype=jnp.float32, fused_stages=5)
    v = randomize(dense_variables(64, 0, fused_stages=5), 0)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    return v, x, np.asarray(jax.jit(b.apply)(v, jnp.asarray(x)))


def _torch_dense(v, fused_stages):
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    return flax_to_torch(v, build_model("dense", dtype=torch.float32,
                                        fused_stages=fused_stages).module)


@pytest.mark.parametrize("fused_stages", [0, 2, 5])
def test_dense_fused_stages_matches_jax(dense_fused, fused_stages):
    from digipathai_tpu_torch.ops import stage_fused

    v, x, want = dense_fused
    m = _torch_dense(v, fused_stages)
    with mock.patch.object(stage_fused, "fused_up_stage",
                           wraps=stage_fused.fused_up_stage) as spy, \
            torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert spy.call_count == fused_stages
    assert got.shape == want.shape == (1, 64, 64, 2)
    assert np.abs(got - want).max() <= 1e-4


def test_batch_of_two_takes_the_canonical_decoder(dense_fused):
    """At N > 1 (patch mode) the fused stages fall back, as in JAX."""
    from digipathai_tpu_torch.ops import stage_fused

    v, x, _ = dense_fused
    m = _torch_dense(v, 2)
    x2 = np.concatenate([x, x[:, ::-1]])
    with mock.patch.object(stage_fused, "fused_up_stage") as spy, \
            torch.inference_mode():
        p = m(torch.from_numpy(x2)).numpy()
    assert spy.call_count == 0
    assert p.shape == (2, 64, 64, 2) and np.isfinite(p).all()


def test_bridge_loads_a_fused_stages_model(dense_fused):
    """flax_to_torch raises on any missing or unexpected name, so a clean
    load means the fused model keeps the canonical parameter names."""
    from digipathai_tpu_torch.models.registry import build_model

    v = dense_fused[0]
    m = _torch_dense(v, 5)
    assert len(m.state_dict()) == len(jax.tree_util.tree_leaves(v))
    np.testing.assert_array_equal(m.conv2d_9.kernel.detach().numpy(),
                                  v["params"]["conv2d_9"]["kernel"])
    # s2d_decoder turns fused_stages off, as in JAX
    assert build_model("dense", fused_stages=5,
                       s2d_decoder=True).module.fused_stages == 0
