"""The row-halo exchange layer (``parallel/spatial.py``) and the spatially
sharded tile step on the CPU, against their unsharded selves and JAX.

- every sharded op against the unsharded op on the same f32 input, 1e-6:
  convs (kernel 1/3/5/7, 1x7 and 7x1, stride 1/2, dilation up to 18,
  depthwise), ``same_pad`` at odd and even heights, both pools
  (``count_include_pad=False`` included), ``upsample2x``, the nearest
  repeat, ``subsample``, align-corners resizes (up 4x and to an arbitrary
  size), the global mean, the windowed pool, and ``fused_conv3x3`` and
  ``fused_up_stage`` (their plain versions on a CPU tensor) on gathered
  blocks.  Over D in {2, 3, 4, 8} strips inside ``run_lockstep``, at
  heights that give strips thinner than the halo and empty strips;
- ``halo`` and ``local`` (one deep halo for several convs), and the
  full-depth DenseNet sharded against its own one-device forward;
- the port's ``build_tile_step_sp`` on ``["cpu"] * 8`` against JAX's on
  the 8-device fake mesh (``tests/test_tile_sp.py``'s case and bound);
- the three big models sharded over 2 and 4 strips against JAX's
  one-device ``build_tile_step``, f32, 1e-5;
- the engine: ``spatial_shard=True`` on ``["cpu"] * 4`` with the oracle
  gives JAX's sharded engine run bit for bit; a small dense run with
  ``crf=True`` gives the port's serial run within 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

OP_TOL = 1e-6
TOL = 1e-5  # tests/test_tile_sp.py's bound
STRIPS = [2, 3, 4, 8]


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """No test reaches the network for weights."""
    monkeypatch.setenv("DPAI_OFFLINE", "1")


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


def _sharded(op, xs, d):
    """``op`` on ``xs`` (tensors of one height or of heights that keep
    their ratio) split into d strips, inside ``run_lockstep``; the result
    gathered whole."""
    from digipathai_tpu_torch.parallel import spatial

    devs = ["cpu"] * d
    shards = [spatial.shard_rows(x, devs) for x in xs]
    rest = shards[1:]
    out = spatial.run_lockstep(
        lambda i, blk: op(blk, *(r.blocks[i] for r in rest)),
        list(range(d)), shards[0])
    return spatial.unshard(out, "cpu")


def _check(op, xs, d, tol=OP_TOL):
    want = op(*xs)
    got = _sharded(op, xs, d)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    return want


# (kernel (kh, kw), stride, padding, dilation, depthwise)
CONVS = [
    ((1, 1), 1, 0, 1, False), ((3, 3), 1, 1, 1, False),
    ((3, 3), 2, 1, 1, False), ((7, 7), 2, 3, 1, False),
    ((5, 5), 1, 2, 1, False), ((1, 7), 1, (0, 3), 1, False),
    ((7, 1), 1, (3, 0), 1, False), ((1, 1), 2, 0, 1, False),
    ((3, 3), 1, 6, 6, True), ((3, 3), 1, 18, 18, True),
    ((3, 3), 2, 1, 1, True),
]


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("conv", CONVS, ids=lambda c: "k{}x{}s{}p{}d{}{}".format(
    *c[0], c[1], c[2], c[3], "dw" if c[4] else ""))
def test_conv2d(conv, d):
    """Heights 40 and 13: strips of 5 and of 1 or 2 rows (thinner than a
    7x7 or a dilation-18 halo), empty where D = 8 > 13 / 2."""
    from digipathai_tpu_torch.parallel import spatial

    (kh, kw), stride, pad, dil, dw = conv
    c = 6
    cin = 1 if dw else c
    # fan-in scaled, as the models' inits: outputs of order 1, where 1e-6
    # is a few f32 roundings of a sum taken in another order
    w = _x(c, cin, kh, kw, seed=1) / (cin * kh * kw) ** 0.5
    for h in (40, 13):
        _check(lambda t: spatial.conv2d(t, w, stride, pad, dil,
                                        c if dw else 1),
               [_x(1, h, 17, c)], d)


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("h", [21, 22, 5])
def test_same_pad_then_strided_ops(h, d):
    """``same_pad`` at odd and even heights (the rows it adds depend on the
    global height), alone and before a stride-2 conv and max pool."""
    from digipathai_tpu_torch.parallel import spatial

    w = _x(4, 3, 3, 3, seed=2) / 27 ** 0.5
    x = [_x(1, h, 9, 3, seed=h)]
    _check(lambda t: spatial.same_pad(t, 3, 3, 2), x, d)
    _check(lambda t: spatial.conv2d(spatial.same_pad(t, 3, 3, 2), w,
                                    stride=2), x, d)
    _check(lambda t: spatial.max_pool2d(spatial.same_pad(t, 3, 3, 2), 3,
                                        stride=2), x, d)


POOLS = [
    ("max", 3, 2, 1, True), ("max", 2, None, 0, True),
    ("avg", 2, None, 0, True), ("avg", 3, 1, 1, False),
    ("avg", 3, 2, 1, False), ("avg", 4, 4, 0, True),
]


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("pool", POOLS, ids=lambda p: "{}{}s{}p{}{}".format(
    p[0], p[1], p[2], p[3], "" if p[4] else "_nopadcount"))
def test_pools(pool, d):
    from digipathai_tpu_torch.parallel import spatial

    kind, k, s, p, cip = pool
    for h in (32, 9):
        x = [_x(1, h, 12, 5, seed=h)]
        if kind == "max":
            _check(lambda t: spatial.max_pool2d(t, k, s, p), x, d)
        else:
            _check(lambda t: spatial.avg_pool2d(t, k, s, p, cip), x, d)


@pytest.mark.parametrize("d", STRIPS)
def test_upsamples_and_subsample(d):
    from digipathai_tpu_torch.parallel import spatial

    for h in (16, 3):
        x = [_x(1, h, 5, 4, seed=h)]
        _check(spatial.upsample2x, x, d)
        _check(lambda t: spatial.repeat_interleave(t, 4), x, d)
        _check(lambda t: spatial.subsample(t, 2), x, d)


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("src,out", [((17, 17), (68, 68)),
                                     ((6, 9), (64, 37)), ((64, 64), (21, 30)),
                                     ((1, 1), (12, 10))])
def test_resize_align_corners(src, out, d):
    """Up 4x (DeepLab's decoder), to an arbitrary size, down, and from one
    pixel."""
    from digipathai_tpu_torch.parallel import spatial

    _check(lambda t: spatial.resize_bilinear_align_corners(t, out),
           [_x(1, *src, 3, seed=src[0])], d)


@pytest.mark.parametrize("d", STRIPS)
def test_global_mean_then_replicated_resize(d):
    """DeepLab's global image pooling: the mean from f32 strip sums, the
    same whole on every strip (checked through ``all_max`` of its
    difference), then resized to the strips' rows; at a height where
    strips are empty too."""
    from digipathai_tpu_torch.parallel import spatial

    for h in (24, 5):
        x = _x(1, h, 10, 6, seed=h)
        want = spatial.global_mean(x)

        def pooled(t):
            b4 = spatial.global_mean(t)
            spread = spatial.all_max((b4 - want).abs().max())
            assert float(spread) <= OP_TOL
            return spatial.resize_bilinear_align_corners(b4 * 2.0, (h, 10),
                                                         replicated=True)
        _check(pooled, [x], d)


@pytest.mark.parametrize("d", STRIPS)
def test_windowed_pool(d):
    """DeepLab's windowed image pooling: VALID means over 4-row windows
    that straddle strips, then each repeated over its window."""
    from digipathai_tpu_torch.parallel import spatial

    _check(lambda t: spatial.repeat_interleave(
        spatial.avg_pool2d(t, 4, stride=4), 4),
        [_x(1, 36, 8, 5, seed=4)], d)


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("pre", [False, True], ids=["plain", "pre_affine"])
def test_fused_conv3x3_on_blocks(pre, d):
    """The conv kernel's plain version on each strip's gathered block (one
    real row on each interior side, pre-activation on it), cropped."""
    from digipathai_tpu_torch.ops import conv_fused
    from digipathai_tpu_torch.parallel import spatial

    c, f = 8, 6
    kw = dict(bias=_x(f, seed=5), mul=_x(f, seed=6) + 2, add=_x(f, seed=7))
    if pre:
        kw.update(pre_mul=_x(c, seed=8), pre_add=_x(c, seed=9))
    ops = conv_fused.prepare(_x(3, 3, c, f, seed=10) / (9 * c) ** 0.5, **kw,
                             dtype=torch.float32, device="cpu")
    for h in (24, 7):
        x = [_x(1, h, 11, c, seed=h)]
        want = _check(lambda t: spatial.fused_conv3x3(t, ops), x, d)
        np.testing.assert_allclose(
            want.numpy(), conv_fused.fused_conv3x3_plain(x[0], ops).numpy(),
            rtol=0, atol=0)


@pytest.mark.parametrize("d", STRIPS)
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
def test_fused_up_stage_on_blocks(skip, d):
    """The stage kernel's plain version on y rows with a margin on each
    interior side and the matching skip rows, cropped; heights whose
    upsampled strips start at odd rows."""
    from digipathai_tpu_torch.ops import stage_fused
    from digipathai_tpu_torch.parallel import spatial

    c, cs, f = 6, 4 if skip else 0, 5
    ops = stage_fused.prepare_stage(
        _x(3, 3, c, f, seed=11) / (9 * c) ** 0.5, _x(f, seed=12),
        _x(f, seed=13) + 2, _x(f, seed=14),
        _x(3, 3, f + cs, f, seed=15) / (9 * (f + cs)) ** 0.5, _x(f, seed=16),
        _x(f, seed=17) + 2, _x(f, seed=18), dtype=torch.float32,
        device="cpu")
    for hh in (13, 4):
        xs = [_x(1, hh, 7, c, seed=hh)]
        if skip:
            xs.append(_x(1, 2 * hh, 14, cs, seed=hh + 1))
        _check(lambda y, *s: spatial.fused_up_stage(
            y, ops[0], None, None, None, ops[1], None, None, None,
            s[0] if s else None), xs, d)


@pytest.mark.parametrize("d", STRIPS)
def test_deep_halo_serves_several_convs(d):
    """``halo(x, 3)`` then three 3x3 convs under ``local()`` (no exchange)
    and ``keep``: the unsharded three convs, at heights where the halo
    reaches past the next strip and where strips are empty."""
    from digipathai_tpu_torch.parallel import spatial

    ws = [_x(4, 4, 3, 3, seed=20 + i) / 6.0 for i in range(3)]

    def three(t):
        for w in ws:
            t = spatial.conv2d(t, w, padding=1)
        return t

    def deep(t):
        ext, keep = spatial.halo(t, len(ws))
        with spatial.local():
            return keep(three(ext))

    for h in (24, 5):
        x = _x(1, h, 6, 4, seed=h)
        got = _sharded(deep, [x], d)
        np.testing.assert_allclose(got.numpy(), three(x).numpy(), rtol=0,
                                   atol=OP_TOL)


@pytest.mark.parametrize("d", STRIPS)
def test_full_densenet_sharded_equals_serial(d):
    """The full DenseNet121-U-Net (blocks 6, 12, 24, 16: halos of 6 to 24
    rows over strips of 8 rows down to empty ones at 64^2) with
    fused_stages=5, sharded against its own one-device forward, f32."""
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.parallel import spatial
    from digipathai_tpu_torch.parallel.inference import replicas

    m = build_model("dense", dtype=torch.float32, fused_stages=5).init(
        64, seed=3)
    x = _x(1, 64, 64, 3, seed=4)
    with torch.inference_mode():
        want = m(x)
    mods = [r[0] for r in replicas([m], ["cpu"] * d)]
    with torch.inference_mode():
        got = spatial.unshard(spatial.run_lockstep(
            lambda mm, xs: mm(xs), mods,
            spatial.shard_rows(x, ["cpu"] * d)), "cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_gather_rows_reports_outside_rows():
    from digipathai_tpu_torch.parallel import spatial

    x = _x(1, 10, 3, 2)
    shards = spatial.shard_rows(x, ["cpu"] * 4)
    assert [b.shape[1] for b in shards.blocks] == [2, 3, 2, 3]
    assert spatial.partition(3, 8) == [(0, 0), (0, 0), (0, 1), (1, 1),
                                       (1, 1), (1, 2), (2, 2), (2, 3)]
    blk, above, below = spatial.gather_rows(shards, -3, 12, "cpu", fill=7.0)
    assert (above, below) == (3, 2) and blk.shape[1] == 15
    assert torch.equal(blk[:, 3:13], x) and (blk[:, :3] == 7).all() \
        and (blk[:, 13:] == 7).all()
    blk, above, below = spatial.gather_rows(shards, -2, 4, "cpu")
    assert (above, below) == (2, 0) and torch.equal(blk, x[:, :4])
    view, _, _ = spatial.gather_rows(shards, 5, 7, "cpu")  # inside block 2
    assert view.data_ptr() == shards.blocks[2].data_ptr()


def test_lockstep_failure_stops_every_strip():
    """A strip that raises stops the others (which wait at an exchange)
    and the error reaches the caller."""
    from digipathai_tpu_torch.parallel import spatial

    def fn(i, blk):
        if i == 2:
            raise KeyError("strip 2")
        return spatial.upsample2x(blk)

    shards = spatial.shard_rows(_x(1, 8, 3, 2), ["cpu"] * 4)
    with pytest.raises(KeyError, match="strip 2"):
        spatial.run_lockstep(fn, list(range(4)), shards)
    # strips that take different paths are caught at the exchange
    with pytest.raises(RuntimeError, match="different code paths"):
        spatial.run_lockstep(
            lambda i, b: spatial.upsample2x(b) if i else b,
            list(range(4)), shards)


def test_lockstep_stress():
    """Sixteen strips (more than this machine's cores) through 300
    exchanges each, the interpreter switching threads every microsecond:
    every strip sees every strip's post of the same round, in strip
    order, and the run ends within its time limit."""
    import sys
    import threading

    from digipathai_tpu_torch.parallel import spatial

    d, rounds = 16, 300
    seen = [[] for _ in range(d)]

    def fn(i, blk):
        for k in range(rounds):
            posts, rank = spatial._exchange(((i, k),))
            seen[i].append([p[0][0] for p in posts])
        return blk

    result = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: result.append(
            spatial.run_lockstep(fn, list(range(d)), spatial.shard_rows(
                _x(1, d, 2, 1), ["cpu"] * d))))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(result) == 1
    for i in range(d):
        assert seen[i] == [[(j, k) for j in range(d)] for k in range(rounds)]


def test_strip_threads_live_across_runs():
    """The same thread runs strip i of every run (cuDNN keeps its plans per
    thread), runs give the same result, and ``close`` ends the threads."""
    import threading

    from digipathai_tpu_torch.parallel import spatial

    shards = spatial.shard_rows(_x(1, 12, 5, 3), ["cpu"] * 3)
    seen = []

    def fn(i, blk):
        seen.append((i, threading.get_ident()))
        return spatial.upsample2x(blk)

    threads = spatial.StripThreads(3)
    outs = [spatial.unshard(threads.run(fn, [0, 1, 2], shards), "cpu")
            for _ in range(3)]
    assert len(set(seen)) == 3 and len(seen) == 9
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="3 threads"):
        threads.run(fn, [0, 1], spatial.shard_rows(_x(1, 4, 2, 2),
                                                   ["cpu"] * 2))
    threads.close()
    assert not any(t.is_alive() for t in threads._threads)


# ----------------------------------------------------------- the tile step

def test_sp_step_matches_jax_sp_step(rng):
    """``tests/test_tile_sp.py``'s case: TinyUNet, tile 96 + 2 x 16, TTA
    DEFAULT and ROTATE_90, f32, 8 strips against JAX's 8-device mesh."""
    from jax.sharding import Mesh

    from digipathai_tpu.engine.tile_infer import build_tile_step_sp as jsp
    from digipathai_tpu.models.registry import build_model as jbuild
    from digipathai_tpu_torch.engine.tile_infer import build_tile_step_sp
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tbuild
    from digipathai_tpu_torch.parallel.inference import replicas

    tile, halo, tta = 96, 16, ["DEFAULT", "ROTATE_90"]
    jb = jbuild("tiny", dtype=jnp.float32)
    v = jb.init(tile + 2 * halo)
    img = rng.integers(0, 255, (tile + 2 * halo, tile + 2 * halo, 3)
                       ).astype(np.uint8)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    wm, wv = jsp([jb], tta, tile, halo, mesh, compute_dtype=jnp.float32)(
        (v,), jnp.asarray(img))

    tb = tbuild("tiny", dtype=torch.float32)
    module = flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(v)),
                           tb.module).eval()
    devices = ["cpu"] * 8
    step = build_tile_step_sp([tb], tta, tile, halo, devices,
                              compute_dtype=torch.float32)
    gm, gv = step(replicas([module], devices), img)
    step.close()
    assert tuple(gm.shape) == (tile, tile)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=TOL)
    assert float(gv.max()) > 0


BIG = {  # port kwargs, JAX kwargs (JAX's canonical decoder: the fused
    # stage is its exact rewrite, held to it by test_torch_stage_fused.py)
    "dense": (dict(blocks=(1, 1, 1, 1), fused_stages=5),
              dict(blocks=(1, 1, 1, 1))),
    "inception": (dict(fused_stages=5), {}),
    "deeplabv3": ({}, {}),
    "deeplabv3-window": (dict(aspp_pool_window=32),
                         dict(aspp_pool_window=32)),
}


@pytest.fixture(scope="module")
def big_models():
    """name -> (JAX bundle, flax tree, port bundle, port module), f32, the
    trees randomized so every BatchNorm and bias counts."""
    from digipathai_tpu.models.registry import build_model as jbuild
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tbuild
    from tests.torch_parity import dense_variables, model_variables, randomize

    out = {}
    for i, (key, (tkw, jkw)) in enumerate(BIG.items()):
        name = key.split("-")[0]
        if name == "dense":
            v = dense_variables(64, 0, **jkw)
        else:
            v = model_variables(name, 64, 0)
        v = randomize(v, i)
        if name == "deeplabv3":
            v["params"]["custom_logits_semantic"]["kernel"] *= 20.0
        jb = jbuild(name, dtype=jnp.float32, **jkw)
        tb = tbuild(name, dtype=torch.float32, **tkw)
        out[key] = (jb, v, tb, flax_to_torch(v, tb.module).eval())
    return out


@pytest.mark.parametrize("key", list(BIG))
def test_big_models_sharded_match_jax_one_device(key, big_models):
    """Tile 32 + 2 x 16 (64 rows: strips of 32 and 16, and at /32 two rows
    over four strips, so two are empty), TTA DEFAULT and ROTATE_90, over 2
    and 4 strips: within 1e-5 of JAX's one-device tile step, f32."""
    from digipathai_tpu.engine.tile_infer import build_tile_step as jstep
    from digipathai_tpu_torch.engine.tile_infer import build_tile_step_sp
    from digipathai_tpu_torch.parallel.inference import replicas

    jb, v, tb, module = big_models[key]
    tile, halo, tta = 32, 16, ["DEFAULT", "ROTATE_90"]
    img = np.random.default_rng(len(key)).integers(
        0, 255, (tile + 2 * halo, tile + 2 * halo, 3)).astype(np.uint8)
    wm, wv = jstep([jb], tta, tile, halo, compute_dtype=jnp.float32)(
        (v,), jnp.asarray(img))
    assert float(np.asarray(wv).max()) > 0
    for d in (2, 4):
        devices = ["cpu"] * d
        step = build_tile_step_sp([tb], tta, tile, halo, devices,
                                  compute_dtype=torch.float32)
        gm, gv = step(replicas([module], devices), img)
        step.close()
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0,
                                   atol=TOL, err_msg=f"{key} mean, D={d}")
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                                   atol=TOL, err_msg=f"{key} var, D={d}")


@pytest.mark.parametrize("key, quantized", [
    ("dense", True), ("dense", "static"), ("inception", True),
    ("deeplabv3", True), ("deeplabv3", "static")])
def test_int8_sharded_equals_one_device(key, quantized, big_models):
    """int8 on the sharded step (``models/quant.py``: dynamic scales by
    ``spatial.all_max`` over the strips, static ones from the calibrated
    ``amax``, the VALID int8 conv through ``spatial.valid_rows``): tile
    32 + 2 x 16, TTA DEFAULT and ROTATE_90, over 2 and 4 strips, against
    the port's one-device step, f32, at the f32 sharded step's bound.
    The trees are randomized, so DeepLab's static map is not the constant
    0.5 of the seeded init."""
    import copy

    from digipathai_tpu_torch.engine.tile_infer import (build_tile_step,
                                                        build_tile_step_sp)
    from digipathai_tpu_torch.models import quant
    from digipathai_tpu_torch.ops.color import normalize_patches
    from digipathai_tpu_torch.parallel.inference import replicas

    _, _, tb, module = big_models[key]
    module = copy.deepcopy(module)
    module.quantized = quant.mode_of(quantized)
    tile, halo, tta = 32, 16, ["DEFAULT", "ROTATE_90"]
    img = np.random.default_rng(len(key) + 20).integers(
        0, 255, (tile + 2 * halo, tile + 2 * halo, 3)).astype(np.uint8)
    if quantized == "static":
        quant.calibrate(module, [normalize_patches(
            torch.from_numpy(img)[None], torch.float32)])
    wm, wv = build_tile_step([tb], tta, tile, halo,
                             compute_dtype=torch.float32,
                             device="cpu")([module], img)
    assert float(wv.max()) > 0 and float(wm.std()) > 0
    for d in (2, 4):
        devices = ["cpu"] * d
        step = build_tile_step_sp([tb], tta, tile, halo, devices,
                                  compute_dtype=torch.float32)
        try:
            gm, gv = step(replicas([module], devices), img)
        finally:
            step.close()
        np.testing.assert_allclose(gm.numpy(), wm.numpy(), rtol=0,
                                   atol=TOL, err_msg=f"mean, D={d}")
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=0,
                                   atol=TOL, err_msg=f"var, D={d}")


# -------------------------------------------------------------- the engine

def _engine(engine, slide, out_dir, monkeypatch, **kw):
    """One engine run with its own cache: (mask, {mean, var, count}, the
    u8 probability TIFF's level 0)."""
    from digipathai_tpu_torch.io.slide import Slide

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("DPAI_CACHE", str(out_dir / "cache"))
    paths = {k: str(out_dir / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    mask = np.asarray(engine(img_path=slide, **paths, quick=True,
                             mode="breast", num_workers=2, **kw)).copy()
    mm = out_dir / "cache" / "memmaps"
    maps = {k: np.fromfile(next(mm.glob(f"*-{k}.dat")), np.float32)
            for k in ("mean", "var", "count")}
    with Slide(paths["probs_path"]) as sl:
        probs = np.asarray(sl.read_level(0))
    return mask, maps, probs


@pytest.fixture(scope="module")
def sp_slide(tmp_path_factory):
    from tests.fixtures import make_synthetic_slide

    p = tmp_path_factory.mktemp("sp") / "sp-slide.tiff"
    make_synthetic_slide(str(p), 768, 768, seed=43)
    return str(p)


TILE_KW = dict(patch_size=128, stride_size=128, batch_size=4, supertile=384,
               inference_mode="tile")


def _spy_sp(monkeypatch):
    from digipathai_tpu_torch.engine import tile_infer

    calls = []
    real = tile_infer.build_tile_step_sp
    monkeypatch.setattr(tile_infer, "build_tile_step_sp",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    return calls


def test_oracle_sp_engine_matches_jax_bit_for_bit(sp_slide, tmp_path,
                                                  monkeypatch):
    """spatial_shard=True, the oracle, four strips on ``["cpu"] * 4``
    against JAX's sharded engine run on four of its devices: the mask, the
    u8 probability map and the count map bit for bit, and the mean and
    variance maps equal to the port's serial run's bit for bit.  Against
    JAX those two are held to the one-device oracle parity's 1e-6
    (``test_torch_tile.py::test_oracle_tile_engine_matches_jax``): XLA's
    sigmoid and torch's differ by an f32 ulp on some pixels."""
    from digipathai_tpu.engine.segmentation import getSegmentation as jseg
    from digipathai_tpu_torch import getSegmentation

    kw = dict(model="oracle", **TILE_KW)
    want = _engine(jseg, sp_slide, tmp_path / "j", monkeypatch,
                   data_parallel=4, spatial_shard=True, **kw)
    serial = _engine(lambda **a: getSegmentation(**a, device="cpu"),
                     sp_slide, tmp_path / "s", monkeypatch, **kw)
    calls = _spy_sp(monkeypatch)
    got = _engine(lambda **a: getSegmentation(**a, device=["cpu"] * 4),
                  sp_slide, tmp_path / "t", monkeypatch, spatial_shard=True,
                  **kw)
    assert len(calls) == 1 and len(calls[0]) == 4
    assert got[0].any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1]["count"], want[1]["count"])
    for k in ("mean", "var"):
        np.testing.assert_array_equal(got[1][k], serial[1][k], err_msg=k)
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_dense_sp_engine_with_crf_equals_serial(sp_slide, tmp_path,
                                                monkeypatch):
    """A blocks=(1, 1, 1, 1) DenseNet with fused_stages=5 and crf=True in
    f32: the sharded run on two strips gives the serial run's maps within
    1e-5, each supertile's CRF on the first device."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.models import registry
    from digipathai_tpu_torch.ops import crf as tcrf

    build = registry.build_model
    monkeypatch.setattr(registry, "build_model", lambda name, **k: build(
        name, **{**k, "blocks": (1, 1, 1, 1)}))
    seen = []
    refine = tcrf.refine_tile

    def spy(*a, device=None, **k):
        seen.append(str(device))
        return refine(*a, device=device, **k)

    monkeypatch.setattr(tcrf, "refine_tile", spy)
    kw = dict(model="dense", crf=True, compute_dtype=torch.float32,
              fused_stages=5, crf_opts={"n_iters": 2, "bil_radius": 4},
              **TILE_KW)
    serial = _engine(lambda **a: getSegmentation(**a, device="cpu"),
                     sp_slide, tmp_path / "s", monkeypatch, **kw)
    calls = _spy_sp(monkeypatch)
    sp = _engine(lambda **a: getSegmentation(**a, device=["cpu"] * 2),
                 sp_slide, tmp_path / "p", monkeypatch,
                 spatial_shard=True, **kw)
    assert len(calls) == 1 and seen and set(seen) == {"cpu"}
    assert serial[1]["mean"].max() > 0
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(sp[1][k], serial[1][k], rtol=0, atol=TOL,
                                   err_msg=k)
    near = np.abs(serial[1]["mean"].reshape(serial[0].T.shape) - 0.3) <= TOL
    assert not ((sp[0] != serial[0]) & ~near.T).any()
