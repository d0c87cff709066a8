"""The port's training (``digipathai_tpu_torch/training``) against JAX's.

The losses and adam are held to JAX's on the same arrays.  A train step of
TinyUNet and of a DenseNet121-U-Net with ``blocks=(1, 1, 1, 1)`` runs on
parameters bridged from one flax tree against JAX's jitted
``make_train_step``; the gradients are read from JAX's adam state (after a
first step from zero moments ``mu = 0.1 g``, after a second ``mu2 = 0.9 mu1
+ 0.1 g2``), so no separate gradient is compiled.

JAX's f32 gradient of the DenseNet is the noisy side on the CPU: it is
within 3.6e-2 of the scale of JAX's own gradient computed in f64, and moves
by up to 7.6e-2 under a 1e-6 relative change of the input.  So the
DenseNet's f32 step is held to JAX's f32 step in its loss and batch
statistics, and its gradients to JAX's step computed in f64
(``jax.enable_x64``, f32 parameters) by the whole tree's norm: single f32
leaves move by up to 5.1e-2 of their scale from seed to seed, the tree by
at most 5.1e-3 of its norm (eight seeds, torch 2.13, jax 0.9).  The port in
f64 is held to JAX in f64 leaf by leaf.  A conv bias in front of
a train-mode BatchNorm has a gradient of exactly 0 (the BatchNorm takes the
batch mean out), which both sides compute as rounding noise: each leaf's
scale is floored at 1e-3 of the tree's largest |g|.

Inception and DeepLab are held in their train-mode forwards (f32) and
batch statistics; JAX's DeepLab cannot take a train step at all (its step
passes no dropout rng), so flax's ``nn.Dropout`` is patched to the identity
and the port's rate set to 0 for that comparison.
"""

from unittest import mock

import flax.linen as nn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-4       # of each leaf's scale
STATS_TOL = 1e-5
FLOOR = 1e-3          # a leaf's scale is at least FLOOR * the tree's max|g|
FWD_TOL = 1e-4
# f32 DenseNet step's gradient tree against JAX's f64 step, over its norm;
# over seeds 0-7 (tree and batch; tools/torch_train_grad_seeds.py):
# 7.3e-6 to 5.1e-3
F32_GRAD_TOL = 3e-2
# bf16 DenseNet step against JAX's f64 step; measured (torch 2.13): loss
# 8.2e-4 relative, batch statistics 7.6e-4, the gradient tree 0.60 of its
# norm.  JAX's own bf16 step: 1.3e-5, 8.4e-4 and 0.51 (XLA keeps more of its
# elementwise chains in f32).  A zero gradient would be 1.0, a sign flip 2.
BF16_LOSS_TOL = 3e-3
BF16_STATS_TOL = 3e-3
BF16_GRAD_TOL = 0.8   # ||dg|| / ||g|| over the whole tree
DENSE = dict(blocks=(1, 1, 1, 1))


def _flat(tree):
    from digipathai_tpu_torch.models.bridge import _flatten

    return {k: np.asarray(v, np.float64) for k, v in _flatten(tree).items()}


def _batch(n, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, size, size))]
    return x, y


def _jax_steps(name, variables, x, y, dtype, x64=False, steps=2, **kw):
    """JAX's jitted ``make_train_step`` from ``variables`` and fresh adam
    state, ``steps`` times on (x, y) -> per step (loss, gradients, new
    batch_stats, variables, opt_state) as numpy."""
    from digipathai_tpu.models.registry import build_model
    from digipathai_tpu.training.losses import make_optimizer
    from digipathai_tpu.training.train import make_train_step

    out = []
    with jax.enable_x64(x64):
        step = jax.jit(make_train_step(build_model(name, dtype=dtype, **kw)))
        v, o = variables, make_optimizer().init(variables["params"])
        prev = None
        for _ in range(steps):
            v, o, loss = step(v, o, jnp.asarray(x), jnp.asarray(y))
            mu = _flat(o[0].mu)
            g = {k: (m if prev is None else m - 0.9 * prev[k]) / 0.1
                 for k, m in mu.items()}
            prev = mu
            v_np = jax.tree_util.tree_map(np.asarray, v)
            out.append((float(loss), g, _flat(v_np.get("batch_stats", {})),
                        v_np, jax.tree_util.tree_map(np.asarray, o)))
    return out


def _port_step(name, variables, x, y, dtype, opt_state=None, **kw):
    """One port train step from ``variables`` (and JAX's adam state) ->
    (loss, gradients, new batch_stats, the train state)."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training import train

    bundle = build_model(name, dtype=dtype, **kw)
    model = flax_to_torch(variables, bundle.module).eval()
    state = train.TrainState(model, train.make_optimizer(model.parameters()))
    if opt_state is not None:
        train.adam_state_from_optax(opt_state, state)
    loss = train.make_train_step()(state, torch.from_numpy(x),
                                      torch.from_numpy(y))
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    return (float(loss), grads,
            _flat(torch_to_flax(model).get("batch_stats", {})), state)


def _grad_errors(want, got):
    """Per leaf max|dg| over the leaf's scale (floored at FLOOR of the
    tree's largest |g|)."""
    assert set(want) == set(got)
    top = max(np.abs(g).max() for g in want.values())
    return {k: np.abs(want[k] - got[k]).max()
            / max(np.abs(want[k]).max(), FLOOR * top) for k in want}


def _stats_error(want, got):
    assert set(want) == set(got)
    return max((np.abs(want[k] - got[k]).max() for k in want), default=0.0)


def _assert_step(want, got, stats=True):
    lw, gw, bw = want[:3]
    lg, gg, bg = got[:3]
    assert abs(lg - lw) <= LOSS_TOL * abs(lw), (lw, lg)
    errs = _grad_errors(gw, gg)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    if stats:
        assert _stats_error(bw, bg) <= STATS_TOL


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("loss", ["categorical_crossentropy",
                                  "soft_dice_loss", "segmentation_loss"])
def test_losses_match_jax(loss):
    from digipathai_tpu.training import losses as jl
    from digipathai_tpu_torch.training import losses as tl

    rng = np.random.default_rng(3)
    p = rng.random((4, 16, 16, 2)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[0, 0, 0] = (0.0, 1.0)  # on both clip bounds
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 16, 16))]
    want = float(getattr(jl, loss)(jnp.asarray(p), jnp.asarray(y)))
    got = float(getattr(tl, loss)(torch.from_numpy(p), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    """``make_optimizer`` against ``optax.adam`` on identical gradients."""
    from digipathai_tpu_torch.training.losses import make_optimizer

    rng = np.random.default_rng(steps)
    shapes = {"a": (3, 3, 4, 8), "b": (8,), "c": (5, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    tx = optax.adam(1e-3)
    jp, state = params, tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), 1e-3)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------------------ train steps


@pytest.fixture(scope="module")
def tiny():
    """TinyUNet at 32^2, batch 4, f32: JAX's two steps."""
    from tests.torch_parity import model_variables

    v = jax.tree_util.tree_map(np.asarray, dict(model_variables("tiny", 32)))
    x, y = _batch(4, 32, 1)
    return v, x, y, _jax_steps("tiny", v, x, y, jnp.float32)


@pytest.fixture(scope="module")
def dense():
    """DenseNet121-U-Net with blocks (1, 1, 1, 1) at 64^2, batch 2: the
    randomized tree, the batch, and JAX's steps by compute dtype."""
    from tests.torch_parity import dense_variables, randomize

    v = randomize(dense_variables(64, 0, **DENSE), 0)
    x, y = _batch(2, 64, 1)
    runs = {"f64": _jax_steps("dense", v, x, y, jnp.float64, x64=True,
                              **DENSE),
            "f32": _jax_steps("dense", v, x, y, jnp.float32, steps=1,
                              **DENSE)}
    return v, x, y, runs


def test_tiny_step_matches_jax(tiny):
    v, x, y, jax_steps = tiny
    got = _port_step("tiny", v, x, y, torch.float32)
    _assert_step(jax_steps[0], got, stats=False)
    assert not got[2] and not jax_steps[0][2]  # no BatchNorm


def _tree_error(want, got):
    """||dg|| / ||g|| over the whole gradient tree."""
    assert set(want) == set(got)
    num = np.sqrt(sum(((want[k] - got[k]) ** 2).sum() for k in want))
    return num / np.sqrt(sum((g ** 2).sum() for g in want.values()))


def test_dense_step_matches_jax_f32(dense):
    """Loss and batch statistics against JAX's f32 step, the gradient tree
    against JAX's step in f64."""
    v, x, y, runs = dense
    got = _port_step("dense", v, x, y, torch.float32, **DENSE)
    lw, _, bw = runs["f32"][0][:3]
    assert abs(got[0] - lw) <= LOSS_TOL * abs(lw)
    assert _stats_error(bw, got[2]) <= STATS_TOL
    err = _tree_error(runs["f64"][0][1], got[1])
    assert err <= F32_GRAD_TOL, err


def test_dense_step_matches_jax_f64(dense):
    v, x, y, runs = dense
    _assert_step(runs["f64"][0], _port_step("dense", v, x, y, torch.float64,
                                            **DENSE))


@pytest.mark.parametrize("model", ["tiny", "dense"])
def test_second_step_from_optax_state(model, tiny, dense):
    """The port continues JAX's run: JAX's first-step variables and adam
    state (``adam_state_from_optax``) give JAX's second step."""
    if model == "tiny":
        _, x, y, steps = tiny
        dtype, kw = torch.float32, {}
    else:
        _, x, y, runs = dense
        steps, dtype, kw = runs["f64"], torch.float64, DENSE
    v1, o1 = steps[0][3], steps[0][4]
    got = _port_step(model, v1, x, y, dtype, opt_state=o1, **kw)
    _assert_step(steps[1], got, stats=model == "dense")
    # the moments after the step: JAX's first-step moments carried over
    state = got[3]
    o2 = steps[1][4][0]
    for key, moment in (("exp_avg", o2.mu), ("exp_avg_sq", o2.nu)):
        want = _flat(moment)
        have = {k: state.optimizer.state[p][key].double().numpy()
                for k, p in state.model.named_parameters()}
        errs = _grad_errors(want, have)
        assert max(errs.values()) <= GRAD_TOL, (key, max(errs, key=errs.get))


def test_adam_state_from_optax_names():
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training import train

    state = train.init_state(build_model("tiny"), 32, device="cpu")
    params = {f"Conv_{i}": {"kernel": np.zeros(1), "bias": np.zeros(1)}
              for i in range(5)}
    opt_state = optax.adam(1e-4).init(params)
    with pytest.raises(KeyError, match="names do not match"):
        train.adam_state_from_optax(opt_state, state)


def test_dense_step_bf16(dense):
    """bf16 compute against JAX's f64 step: the gradient tree by its norm
    (bf16 moves single leaves by up to their scale; JAX's own bf16 step
    too)."""
    v, x, y, runs = dense
    lw, gw, bw = runs["f64"][0][:3]
    lg, gg, bg = _port_step("dense", v, x, y, torch.bfloat16, **DENSE)[:3]
    assert abs(lg - lw) <= BF16_LOSS_TOL * abs(lw)
    assert _stats_error(bw, bg) <= BF16_STATS_TOL
    err = _tree_error(gw, gg)
    assert err <= BF16_GRAD_TOL, err


# ----------------------------------------------------- train-mode forwards


def _spies():
    from digipathai_tpu_torch.ops import conv_fused, stage_fused

    return (mock.patch.object(conv_fused, "fused_conv3x3",
                              wraps=conv_fused.fused_conv3x3),
            mock.patch.object(stage_fused, "fused_up_stage",
                              wraps=stage_fused.fused_up_stage))


def _assert_trains_without_kernels(model, x, y, **kw):
    """A train-mode forward and backward calls neither kernel wrapper and
    gives every parameter a gradient; the same model at inference calls
    the conv wrapper (U-Nets)."""
    from digipathai_tpu_torch.training.losses import segmentation_loss

    spy_conv, spy_stage = _spies()
    with spy_conv as conv, spy_stage as stage:
        model.train()
        probs = model(torch.from_numpy(x), **kw)
        segmentation_loss(probs, torch.from_numpy(y)).backward()
        model.eval()
        assert conv.call_count == stage.call_count == 0
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.count_nonzero(p.grad), name
        if hasattr(model, "_decode") or hasattr(model, "Conv_0"):
            with torch.inference_mode():
                model(torch.from_numpy(x[:1]))
            assert conv.call_count + stage.call_count > 0
    return probs.detach().numpy()


@pytest.mark.parametrize("model", ["tiny", "dense"])
def test_train_mode_runs_no_kernel(model, tiny, dense):
    """Train mode at N == 1, where inference takes the fused stages: every
    parameter gets a gradient and no kernel runs (neither has a
    backward)."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    v, x, y = (tiny if model == "tiny" else dense)[:3]
    kw = {} if model == "tiny" else dict(fused_stages=5, **DENSE)
    m = flax_to_torch(v, build_model(model, dtype=torch.float32,
                                     **kw).module)
    _assert_trains_without_kernels(m, x[:1], y[:1])


@pytest.fixture(scope="module")
def big_variables():
    from tests.torch_parity import model_variables, randomize

    return {name: randomize(model_variables(name, 64, 0), 0)
            for name in ("inception", "deeplabv3")}


@pytest.mark.parametrize("name", ["inception", "deeplabv3"])
def test_train_forward_matches_jax(name, big_variables, monkeypatch):
    """Train-mode forwards (64^2, batch 2) and their new batch statistics
    against flax's ``apply(..., train=True, mutable=["batch_stats"])``; the
    port's forward then trains without a kernel.  DeepLab's dropout is the
    identity on both sides here.  Inception runs in f32.  DeepLab runs in
    f64 on both sides: its image-pooling BatchNorm takes its statistics over
    N = 2 values, and JAX's own f32 train forward is 3.2e-4 from its f64
    one (the port's f32 forward 2.0e-4)."""
    from digipathai_tpu.models.registry import build_model as jax_build
    from digipathai_tpu_torch.models import deeplabv3
    from digipathai_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
    from digipathai_tpu_torch.models.registry import build_model

    v = big_variables[name]
    x, y = _batch(2, 64, 2)
    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, h, *a, **k: h)
    monkeypatch.setattr(deeplabv3, "DROPOUT_RATE", 0.0)
    x64 = name == "deeplabv3"
    with jax.enable_x64(x64):
        module = jax_build(name, dtype=jnp.float64 if x64
                           else jnp.float32).module
        want, new = jax.jit(lambda v, x: module.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        want = np.asarray(want)
        stats = _flat(jax.tree_util.tree_map(np.asarray, new["batch_stats"]))
    kw = dict(fused_stages=5) if name == "inception" else {}
    m = flax_to_torch(v, build_model(
        name, dtype=torch.float64 if x64 else torch.float32, **kw).module)
    got = _assert_trains_without_kernels(m, x, y)
    assert np.abs(got - want).max() <= FWD_TOL
    assert _stats_error(stats, _flat(torch_to_flax(m)["batch_stats"])) \
        <= STATS_TOL


def test_deeplab_dropout_draws_from_the_generator():
    from digipathai_tpu_torch.models import deeplabv3

    y = torch.ones(4, 32, 32, 64)

    def drop(seed):
        return deeplabv3.dropout(y, 0.1,
                                 torch.Generator().manual_seed(seed))

    a, b, c = drop(0), drop(0), drop(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.9))


def test_deeplab_train_forward_needs_a_generator(big_variables):
    """In train mode DeepLab's dropout mask comes from the generator the
    step passes (JAX's step passes no rng and raises InvalidRngError); the
    mask changes the output, the same seed repeats it."""
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    m = flax_to_torch(big_variables["deeplabv3"], build_model(
        "deeplabv3", dtype=torch.float32).module).train()
    x = torch.from_numpy(_batch(1, 64, 3)[0])
    with pytest.raises(ValueError, match="generator"):
        m(x)
    with torch.no_grad():
        a, b, c = (m(x, generator=torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_loss_decreases_on_tiny_unet():
    """``tests/test_training.py::test_loss_decreases_on_tiny_unet`` on the
    port: run until the loss halves, at most 200 steps."""
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training.train import (init_state,
                                                     make_train_step)

    bundle = build_model("tiny")
    state = init_state(bundle, 32, learning_rate=1e-2, device="cpu")
    step = make_train_step()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((4, 32, 32, 3)).astype(np.float32))
    lab = np.zeros((4, 32, 32), np.int64)
    lab[:, 16:] = 1
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[lab])
    first = last = None
    for _ in range(200):
        last = float(step(state, x, y))
        first = last if first is None else first
        if last < first * 0.5:
            break
    assert last < first * 0.5, (first, last)
    assert not state.model.training and state.step <= 200
