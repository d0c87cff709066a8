"""The port's (dp, sp, mp) mesh (``parallel/mesh.py``, ``parallel/channels.py``)
and its sharded train step (``training/train.py::shard_train_step``).

The mesh rules mirror ``tests/test_parallel.py``'s and JAX's ``param_spec``
leaf by leaf.  TinyUNet's mesh step on eight fake CPU devices is held to
JAX's ``shard_train_step`` on the conftest's eight-device mesh (the loss)
and to JAX's serial step (gradients read from JAX's adam moments, as
``tests/test_torch_training.py`` reads them, and the parameters after the
step).  In f64 the DenseNet's mesh step is held to the port's serial step
on the whole batch: only the order of the sums
differs (over strips, batch shards and channel slices), so the loss, every
gradient leaf and the new BatchNorm statistics agree to 1e-9 of their
scale.  The parameters after adam are held absolutely, to 1e-8: where a
gradient component is below adam's eps (1e-8) the update is ``lr * g /
eps``, which passes the gradient's rounding on multiplied by lr / eps =
1e4.

Inception's and DeepLab's f64 mesh steps take 15-25 s of CPU each and
GiBs at their smallest sizes (66M and 41M parameters; DeepLab's f64
depthwise convs one CPU call per channel group), so ``chip_smoke.py``
phase 4e holds them to the serial
step on the card; here the ops only DeepLab's path runs (the depthwise
conv's channel slices, the replicated image pooling, the dropout mask over
batch shards and strips) are held to their unsharded versions, values and
gradients, over an eight-device grid.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

F64_REL = 1e-9      # loss, gradient leaves, BatchNorm statistics
F64_PARAM = 1e-8    # parameters after the adam step, absolute
FLOOR = 1e-3        # a leaf's scale is at least FLOOR * the tree's max|g|
LOSS_TOL = 1e-5     # tests/test_torch_training.py's bounds against JAX
GRAD_TOL = 1e-4
PARAM_TOL = 1e-7    # f32 parameters after the step against JAX's (~1 ulp)
LAYOUTS = {(2, 2, 2): 8, (1, 2, 2): 4}


def _devices(layout):
    return ["cpu"] * LAYOUTS[layout]


def _batch(n, size, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(dtype)
    y = np.eye(2, dtype=dtype)[rng.integers(0, 2, (n, size, size))]
    return torch.from_numpy(x), torch.from_numpy(y)


def _randomize_bn(model, seed):
    """BatchNorm statistics and affines away from their initial values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k.endswith(("scale", "var")):
                t.copy_(torch.rand(t.shape, generator=g, dtype=t.dtype) + 0.5)
            elif k.endswith(("mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g, dtype=t.dtype) * .1)
    return model


def _rel_errors(want, got):
    """Per leaf max|d| over the leaf's scale (floored at FLOOR of the
    tree's largest |value|: a conv bias before a train-mode BatchNorm has a
    gradient of exactly 0, computed as rounding noise)."""
    assert set(want) == set(got)
    top = max(w.abs().max().item() for w in want.values())
    return {k: ((want[k] - got[k]).abs().max()
                / max(want[k].abs().max().item(), FLOOR * top)).item()
            for k in want}


def _stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _mesh_step(model, x, y, layout, generator=None):
    """One mesh step from ``model`` (kept) -> (loss, the mesh state,
    gradients in the serial layout)."""
    from digipathai_tpu_torch.parallel import mesh as mesh_lib
    from digipathai_tpu_torch.training import train

    mesh = mesh_lib.make_mesh(devices=_devices(layout))
    assert tuple(mesh.shape.values()) == layout
    model = copy.deepcopy(model)
    ms = train.shard_state(train.TrainState(
        model, train.make_optimizer(model.parameters())), mesh)
    step = train.shard_train_step(mesh)
    try:
        loss = float(step(ms, x, y, generator=generator))
    finally:
        step.close()
    return loss, ms, mesh_lib.gather_grads(ms.replicas, mesh)


# ------------------------------------------------------------ the rules


def test_factor_devices():
    from digipathai_tpu_torch.parallel.mesh import factor_devices

    assert factor_devices(8) == (2, 2, 2)
    assert factor_devices(4) == (1, 2, 2)
    assert factor_devices(1) == (1, 1, 1)
    dp, sp, mp = factor_devices(16)
    assert dp * sp * mp == 16


def test_make_mesh_validates():
    from digipathai_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="visible"):
        make_mesh(1024)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": 2, "mp": 2}
    assert mesh.flat() == [torch.device("cpu")] * 8
    assert mesh.coords(5) == (1, 0, 1)
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises(ValueError, match="visible"):
            make_mesh()


@pytest.mark.parametrize("name", ["tiny", "dense"])
def test_param_spec_matches_jax(name):
    """``param_spec`` over every parameter and BatchNorm statistic of the
    port's model gives JAX's ``param_spec`` of the same flax leaf."""
    from digipathai_tpu.parallel import mesh as jax_mesh
    from digipathai_tpu_torch.models.bridge import _flatten
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.parallel import mesh as mesh_lib

    from tests.torch_parity import model_variables

    kw = {"blocks": (1, 1, 1, 1)} if name == "dense" else {}
    variables = model_variables(name, 64, 0, **kw)
    leaves = {}
    for collection in ("params", "batch_stats"):
        leaves.update(_flatten(variables.get(collection, {})))
    model = build_model(name, **kw).module
    ours = dict(model.named_parameters())
    ours.update(model.named_buffers())
    assert set(ours) == set(leaves)
    for mp in (1, 2, 4):
        for k, leaf in leaves.items():
            want = tuple(jax_mesh.param_spec(leaf.shape, mp))
            assert mesh_lib.param_spec(tuple(ours[k].shape), mp) == want, k
    assert mesh_lib.sharded_names(model, 2)
    assert mesh_lib.batch_spec() == tuple(jax_mesh.batch_spec())


# ----------------------------------------------------------- against JAX


def test_tiny_mesh_step_matches_jax_shard_train_step():
    """``tests/test_training.py``'s sharded tiny step: the port on
    ``["cpu"] * 8`` at (2, 2, 2) against JAX's ``shard_train_step`` on its
    eight-device mesh, from one flax tree: the loss.  The gradients and the
    parameters after the step are held to JAX's serial step: with sp and
    mp both 2, JAX's sharded step leaves twice the serial gradient in adam's
    moments for Conv_0 to Conv_3 (ROADMAP.md section C), which adam's
    update hides but where a component is near its eps (JAX's sharded
    parameters are up to 1.7e-5 from its serial ones)."""
    from digipathai_tpu.models.registry import build_model as jax_build
    from digipathai_tpu.parallel import mesh as jax_mesh
    from digipathai_tpu.training.train import (init_state, make_train_step,
                                               shard_train_step)
    from digipathai_tpu_torch.models.bridge import _flatten, flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model

    bundle = jax_build("tiny")
    state = init_state(bundle, 32)
    v0 = jax.tree_util.tree_map(np.asarray, state.variables)  # donated below
    x, y = _batch(8, 64, 3)
    mesh = jax_mesh.make_mesh(8)
    variables = jax_mesh.shard_variables(state.variables, mesh)
    opt_state = jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, jax.sharding.NamedSharding(
            mesh, jax_mesh.param_spec(getattr(leaf, "shape", ()),
                                      mesh.shape["mp"])))
        if hasattr(leaf, "shape") else leaf, state.opt_state)
    sharded = shard_train_step(make_train_step(bundle), mesh, variables,
                               opt_state)
    v1, o1, _ = jax.jit(make_train_step(bundle))(
        jax.tree_util.tree_map(jnp.asarray, v0), state.opt_state,
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    v2, o2, loss2 = sharded(variables, opt_state, jnp.asarray(x.numpy()),
                            jnp.asarray(y.numpy()))
    want_g = {k: torch.from_numpy(np.asarray(m, np.float64) / 0.1)
              for k, m in _flatten(o1[0].mu).items()}
    want_p = {k: torch.from_numpy(np.asarray(v, np.float64))
              for k, v in _flatten(v1["params"]).items()}

    model = flax_to_torch(v0, build_model("tiny").module)
    loss, ms, grads = _mesh_step(model, x, y, (2, 2, 2))
    from digipathai_tpu_torch.training.train import unshard

    got_p = {k: p.detach().double() for k, p in
             unshard(ms).named_parameters()}
    assert abs(loss - float(loss2)) <= LOSS_TOL * abs(float(loss2))
    errs = _rel_errors(want_g, {k: g.double() for k, g in grads.items()})
    assert max(errs.values()) <= GRAD_TOL, max(errs, key=errs.get)
    moved = max((want_p[k] - got_p[k]).abs().max().item() for k in want_p)
    assert moved <= PARAM_TOL, moved


# ------------------------------------------ against the port's serial step


@pytest.fixture(scope="module")
def serial_run():
    """A seeded f64 DenseNet with blocks (1, 1, 1, 1), its BatchNorms
    randomized, a (8, 64, 64) batch, and the serial step on it: (model
    before the step, x, y, loss, gradients, statistics, the state)."""
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.training import train

    model = build_model("dense", dtype=torch.float64,
                        blocks=(1, 1, 1, 1)).init(64, seed=0)
    model = _randomize_bn(model.double(), 1)
    x, y = _batch(8, 64, 2, np.float64)
    twin = copy.deepcopy(model)
    st = train.TrainState(twin, train.make_optimizer(twin.parameters()))
    loss = float(train.make_train_step()(st, x, y))
    grads = {k: p.grad.clone() for k, p in twin.named_parameters()}
    return model, x, y, loss, grads, _stats(twin), st


@pytest.fixture(scope="module")
def dense_mesh_run(serial_run):
    """The mesh step from the serial run's model, once per layout."""
    runs = {}

    def get(layout):
        if layout not in runs:
            runs[layout] = _mesh_step(*serial_run[:3], layout)
        return runs[layout]

    return get


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_equals_serial_f64(layout, serial_run, dense_mesh_run):
    """One dense mesh step equals the serial step on the whole batch: the
    loss, every gradient leaf, the new BatchNorm statistics and, after
    adam, every parameter."""
    from digipathai_tpu_torch.training.train import unshard

    model, x, y, loss, grads, stats, st = serial_run
    got_loss, ms, got_grads = dense_mesh_run(layout)
    assert abs(got_loss - loss) <= F64_REL * abs(loss), (got_loss, loss)
    errs = _rel_errors(grads, got_grads)
    assert max(errs.values()) <= F64_REL, max(errs, key=errs.get)
    out = unshard(ms)
    errs = _rel_errors(stats, _stats(out))
    assert max(errs.values()) <= F64_REL, max(errs, key=errs.get)
    want = dict(st.model.named_parameters())
    moved = max((want[k] - p).abs().max().item()
                for k, p in out.named_parameters())
    assert moved <= F64_PARAM, moved


def test_shards_hold_their_slices(serial_run, dense_mesh_run):
    """After a dense step at (2, 2, 2) every replica holds its
    ``param_spec`` slice (or the whole) of each parameter and statistic,
    and adam's moments of that slice equal the serial step's (to F64_REL
    of the largest moment)."""
    from digipathai_tpu_torch.parallel import mesh as mesh_lib
    from digipathai_tpu_torch.training.train import unshard

    st = serial_run[-1]
    _, ms, _ = dense_mesh_run((2, 2, 2))
    whole = unshard(ms).state_dict()
    serial = dict(st.model.named_parameters())
    top = {key: max(st.optimizer.state[p][key].abs().max().item()
                    for p in serial.values())
           for key in ("exp_avg", "exp_avg_sq")}
    n_sharded = 0
    for rank, replica in enumerate(ms.replicas):
        m = ms.mesh.coords(rank)[2]
        for k, t in replica.state_dict().items():
            want = whole[k]
            if mesh_lib.param_spec(want.shape, 2):
                c = want.shape[-1] // 2
                want = want[..., m * c:(m + 1) * c]
                n_sharded += 1
            assert torch.equal(t, want), (rank, k)
        for k, p in replica.named_parameters():
            moments = ms.optimizer.state[p]
            ref = st.optimizer.state[serial[k]]
            for key in ("exp_avg", "exp_avg_sq"):
                want = ref[key]
                if p.shape != want.shape:
                    c = p.shape[-1]
                    want = want[..., m * c:(m + 1) * c]
                err = (moments[key] - want).abs().max().item() / top[key]
                assert err <= F64_REL, (rank, k, key, err)
    assert n_sharded > len(ms.replicas)


def _deeplab_ops(x, kernel, scale, generator):
    """DeepLab's sharded op mix on NHWC ``x``: a dilated depthwise conv on
    the channels of the kernel's slice, gathered; a BatchNorm on batch
    statistics with a gathered scale; dropout; the image pooling's global
    mean, resized back from one replicated row; a bilinear resize; and the
    loss's batch sums."""
    from digipathai_tpu_torch.parallel import channels, spatial

    w = kernel.permute(3, 2, 0, 1)
    y = spatial.conv2d(channels.mine(x, kernel), w, padding=2, dilation=2,
                       groups=w.shape[0])
    y = channels.gather(y, kernel)
    count = y.new_full((1,), y.numel() // y.shape[-1])
    sums = spatial.batch_sum(torch.cat([y.sum((0, 1, 2)),
                                        (y * y).sum((0, 1, 2)), count]))
    mean, mean2 = (sums[:-1] / sums[-1]).chunk(2)
    scale, = channels.whole(scale)
    y = (y - mean) * torch.rsqrt(mean2 - mean * mean + 1e-3) * scale
    y = torch.where(spatial.rand(y, generator) < 0.9, y / 0.9, 0.0)
    _, h, wd, _ = spatial.shape(y)
    y = y + spatial.resize_bilinear_align_corners(spatial.global_mean(y),
                                                  (h, wd), replicated=True)
    y = spatial.resize_bilinear_align_corners(y, (2 * h, 2 * wd))
    return spatial.batch_sum(torch.stack([(y * y).sum(), y.sum()]))


def test_deeplab_ops_on_the_grid_f64():
    """``_deeplab_ops`` over an eight-device (2, 2, 2) grid, each device
    holding its batch shard's rows of its strip and its slice of the
    kernel and the scale, against the unsharded ops: the value and the
    gradients of the input and of every slice, in f64."""
    from digipathai_tpu_torch.parallel import channels, spatial
    from digipathai_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((4, 16, 12, 32)))
    k0 = torch.from_numpy(rng.standard_normal((3, 3, 1, 32)))
    s0 = torch.from_numpy(rng.random(32) + 0.5)

    leaves = [t.clone().requires_grad_() for t in (x0, k0, s0)]
    want = _deeplab_ops(*leaves, torch.Generator().manual_seed(7))
    want.sum().backward()

    mesh = make_mesh(devices=["cpu"] * 8)
    x = x0.clone().requires_grad_()
    slices = [[channels.mark(t[..., m * 16:(m + 1) * 16].clone()
                             .requires_grad_(), m, 2) for m in range(2)]
              for t in (k0, s0)]
    args = []
    for r in range(8):
        d, s, m = mesh.coords(r)
        args.append((x[2 * d:2 * d + 2, 8 * s:8 * s + 8], slices[0][m],
                     slices[1][m]))
    gen = torch.Generator().manual_seed(7)
    threads = spatial.StripThreads(8)
    try:
        got = threads.run_grid(lambda _, a: _deeplab_ops(*a, gen),
                               [None] * 8, args, mesh.flat(),
                               mesh.places())
    finally:
        threads.close()
    got[0].sum().backward()
    assert torch.allclose(got[0], want, rtol=1e-12, atol=0)
    for have, leaf in zip([x.grad] + [torch.cat([t.grad for t in pair], -1)
                                      for pair in slices], leaves):
        scale = leaf.grad.abs().max()
        assert (have - leaf.grad).abs().max() <= 1e-10 * scale


def test_mesh_step_rejects_a_batch_it_cannot_split():
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.parallel.mesh import make_mesh
    from digipathai_tpu_torch.training import train

    mesh = make_mesh(devices=["cpu"] * 8)
    model = build_model("tiny").init(32)
    ms = train.shard_state(train.TrainState(
        model, train.make_optimizer(model.parameters())), mesh)
    step = train.shard_train_step(mesh)
    try:
        with pytest.raises(ValueError, match="dp=2"):
            step(ms, *_batch(3, 64, 0))
        with pytest.raises(ValueError, match="32 \\* sp"):
            step(ms, *_batch(2, 32, 0))
    finally:
        step.close()


def test_dryrun_multichip_on_cpu_devices(capsys):
    from digipathai_tpu_torch.dryrun import dryrun_multichip

    dryrun_multichip(8, devices=["cpu"] * 8, blocks=(1, 1, 1, 1))
    out = capsys.readouterr().out
    assert "mesh: dp=2 sp=2 mp=2" in out
    assert out.count("dryrun_multichip OK") == 3, out
