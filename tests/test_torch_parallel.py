"""The port's multi-device inference on the CPU, against the JAX package's.

JAX runs on the 8-device fake CPU topology that ``tests/conftest.py``
forces; the port runs on device lists that repeat ``cpu``, each entry one
shard with its own model replica and accumulator.  The rule is the one
``tests/test_parallel.py`` and ``tests/test_tile_mode.py`` set for JAX: dp
gives the serial result.  All parity is in f32.

- ``build_sharded_step`` on ``["cpu"] * 8`` against JAX's on the 8-device
  mesh (the oracle model and a DenseNet121-U-Net with blocks (1, 1, 1, 1)
  at 64^2 bridged from one flax tree, two TTA chains, ``mask_predictions``
  off and on) and against the port's serial ``build_step``: 1e-5;
- the engine in patch mode (grid-dp) and tile mode (supertiles dealt
  round-robin, with and without the CRF) against its serial run and JAX's
  multi-device run of the same slide;
- ``make_dp_devices``, ``spatial_shard`` (which scheme runs; the sharded
  step itself is tested in ``test_torch_spatial.py``), the resume key and
  the server's ``--data-parallel``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

TOL = 1e-5  # tests/test_parallel.py's bound
TTA = ["DEFAULT", "ROTATE_90"]
DENSE = dict(blocks=(1, 1, 1, 1))


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """No test reaches the network for weights."""
    monkeypatch.setenv("DPAI_OFFLINE", "1")


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def models():
    """name -> (JAX bundle, flax variables, port bundle, port module), f32;
    the DenseNet's tree randomized so every BatchNorm and bias counts."""
    from digipathai_tpu.models.registry import build_model as jbuild
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tbuild
    from tests.torch_parity import dense_variables, randomize

    out = {}
    jb = jbuild("oracle", dtype=jnp.float32)
    tb = tbuild("oracle", dtype=torch.float32)
    out["oracle"] = (jb, jb.init(64), tb, tb.init(64))
    v = randomize(dense_variables(64, 0, **DENSE), 0)
    jb = jbuild("dense", dtype=jnp.float32, **DENSE)
    tb = tbuild("dense", dtype=torch.float32, **DENSE)
    out["dense"] = (jb, v, tb, flax_to_torch(v, tb.module).eval())
    return out


def _batch(d, b, p, s, seed):
    rng = np.random.default_rng(seed)
    patches = rng.integers(0, 255, (d * b, p, p, 3)).astype(np.uint8)
    # some patches white, so mask_predictions zeroes something
    patches[::3] = 250
    offsets = rng.integers(0, s, (d * b, 2)).astype(np.int32)
    valid = rng.random(d * b) > 0.2
    return patches, offsets, valid


@pytest.mark.parametrize("mask", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", ["oracle", "dense"])
def test_sharded_step_matches_jax_and_serial(name, mask, models):
    """Eight shards of two 64^2 patches on ``["cpu"] * 8``: the reduced
    accumulator within 1e-5 of JAX's ``build_sharded_step`` on the
    8-device mesh and of the port's serial step on the whole batch."""
    from digipathai_tpu.parallel import inference as jpar
    from digipathai_tpu_torch.engine.infer import build_step
    from digipathai_tpu_torch.ops.stitch import make_accumulator
    from digipathai_tpu_torch.parallel import inference as par

    jb, v, tb, module = models[name]
    P, S, B, D = 64, 128, 2, 8
    patches, offsets, valid = _batch(D, B, P, S, seed=len(name) + mask)

    mesh = jpar.make_dp_mesh(D)
    jstep = jpar.build_sharded_step([jb], TTA, P, mesh,
                                    compute_dtype=jnp.float32,
                                    mask_predictions=mask)
    acc = jpar.make_sharded_accumulator(mesh, S, P)
    acc = jstep((v,), acc, *jpar.shard_batch(mesh, patches, offsets, valid))
    want = np.asarray(jpar.reduce_accumulator(mesh, acc))

    devices = par.make_dp_devices(D, ["cpu"] * D)
    replicas = par.replicas([module], devices)
    assert all(r[0] is not module for r in replicas[1:])
    step = par.build_sharded_step([tb], TTA, P, devices,
                                  compute_dtype=torch.float32,
                                  mask_predictions=mask)
    accs = par.make_sharded_accumulator(devices, S, P)
    step(replicas, accs, par.shard_batch(devices, patches, offsets, valid))
    got = par.reduce_accumulator(accs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    serial = build_step([tb], TTA, P, compute_dtype=torch.float32,
                        mask_predictions=mask, device="cpu")
    one = serial([module], make_accumulator(S, P, device="cpu"), patches,
                 offsets, valid).numpy()
    np.testing.assert_allclose(got, one, rtol=0, atol=TOL)
    assert got[2].sum() == 64 * 64 * valid.sum()  # the count plane
    if mask:
        assert (got[0] != 0).any()


def test_shard_batch_and_windowed_reduce():
    """``shard_batch`` gives shard k rows [k*B, (k+1)*B) and refuses a batch
    that does not split; ``reduce_accumulator`` over a window is that window
    of the whole sum, and one accumulator comes back as a view."""
    from digipathai_tpu_torch.parallel import inference as par

    devices = par.make_dp_devices(3, ["cpu"] * 3)
    patches, offsets, valid = _batch(3, 2, 8, 32, seed=5)
    shards = par.shard_batch(devices, patches, offsets, valid)
    assert len(shards) == 3
    for k, (x, o, v) in enumerate(shards):
        rows = slice(2 * k, 2 * k + 2)
        np.testing.assert_array_equal(x.numpy(), patches[rows])
        np.testing.assert_array_equal(o, offsets[rows])
        np.testing.assert_array_equal(v, valid[rows])
    with pytest.raises(ValueError, match="does not split"):
        par.shard_batch(devices, patches[:5], offsets[:5], valid[:5])

    rng = np.random.default_rng(6)
    accs = [torch.from_numpy(rng.random((3, 40, 40), np.float32))
            for _ in devices]
    before = [a.clone() for a in accs]
    whole = (accs[0] + accs[1]) + accs[2]  # shard order
    window = (slice(None), slice(4, 20), slice(8, 30))
    np.testing.assert_array_equal(par.reduce_accumulator(accs, window),
                                  whole[window])
    np.testing.assert_array_equal(par.reduce_accumulator(accs), whole)
    for a, b in zip(accs, before):  # left as they were
        assert torch.equal(a, b)
    one = par.reduce_accumulator(accs[:1], window)
    assert one.data_ptr() == accs[0][window].data_ptr()


def test_replicate_keeps_parameters_ranges_and_drops_caches(models):
    """A replica has the module's parameters and static int8 ranges, and
    none of its prepared operands."""
    from digipathai_tpu_torch.models import quant
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.parallel.inference import replicate

    m = build_model("dense", dtype=torch.float32, quantized="static",
                    **DENSE).module
    m = flax_to_torch(models["dense"][1], m).eval()
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    quant.calibrate(m, [x])
    with torch.inference_mode():
        want = m(x)
    assert any(sub._prepared for sub in m.modules()
               if hasattr(sub, "_prepared"))
    r = replicate(m, "cpu")
    assert all(not sub._prepared for sub in r.modules()
               if hasattr(sub, "_prepared"))
    assert quant.calib_of(m) and (
        quant.calib_of(r).keys() == quant.calib_of(m).keys())
    for k, leaves in quant.calib_of(m).items():
        assert quant.calib_of(r)[k]["amax"] == leaves["amax"]
    for (k, a), (k2, b) in zip(m.state_dict().items(),
                               r.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()
    with torch.inference_mode():
        np.testing.assert_array_equal(r(x).numpy(), want.numpy())


def test_launch_counts_survive_threads():
    """Dispatch and flusher threads bump a kernel wrapper's launch count at
    once (``_build.count_launch``, what every wrapper calls where it
    launches): with the interpreter switching threads every microsecond,
    no count is lost."""
    import sys
    import threading

    from digipathai_tpu_torch import _build
    from digipathai_tpu_torch.ops import bilateral, conv_fused, stage_fused

    wrappers = (conv_fused.fused_conv3x3, stage_fused.fused_up_stage,
                bilateral.bilateral_message)
    before = [w.launches for w in wrappers]
    n_threads, n_bumps = 16, 5000
    go = threading.Barrier(n_threads, timeout=30)

    def bump():
        go.wait()
        for _ in range(n_bumps):
            for w in wrappers:
                _build.count_launch(w)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [n_threads * n_bumps] * 3
    finally:
        sys.setswitchinterval(interval)
        for w, b in zip(wrappers, before):
            w.launches = b


def test_make_dp_devices():
    from digipathai_tpu_torch.parallel.inference import make_dp_devices

    cpu = torch.device("cpu")
    assert make_dp_devices(None, "cpu") == [cpu]
    assert make_dp_devices(None, ["cpu"] * 3) == [cpu] * 3
    assert make_dp_devices(2, ("cpu", "cpu", "cpu")) == [cpu] * 2
    with pytest.raises(ValueError, match="2-device dp run but only 1"):
        make_dp_devices(2, "cpu")
    with pytest.raises(ValueError, match="9-device"):
        make_dp_devices(9, ["cpu"] * 8)
    if not torch.cuda.is_available():
        for dev in ("cuda", "cuda:1", ["cpu", "cuda:0"]):
            with pytest.raises(RuntimeError, match="is_available"):
                make_dp_devices(None, dev)


def test_n_devices_resolves_as_jax():
    from digipathai_tpu_torch.engine.segmentation import _n_devices

    assert _n_devices(True, 4) == 4
    assert _n_devices(False, 4) == _n_devices(0, 4) == 1
    assert _n_devices(2, 4) == 2
    assert _n_devices(16, 4) == 4  # JAX: min(available, data_parallel)


# ---------------------------------------------------------- the engine

def _engine(engine, slide, out_dir, monkeypatch, **kw):
    """One engine run with its own cache: (mask, maps, stdout-free)."""
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
    return mask, maps


def _port(**extra):
    from digipathai_tpu_torch import getSegmentation

    return lambda **kw: getSegmentation(**kw, **extra)


@pytest.fixture(scope="module")
def dp_slide(tmp_path_factory):
    from tests.fixtures import make_synthetic_slide

    p = tmp_path_factory.mktemp("dp") / "dp-slide.tiff"
    make_synthetic_slide(str(p), 512, 512, seed=21)
    return str(p)


@pytest.fixture(scope="module")
def tile_slide(tmp_path_factory):
    from tests.fixtures import make_synthetic_slide

    p = tmp_path_factory.mktemp("mt") / "mt-slide.tiff"
    make_synthetic_slide(str(p), 768, 768, seed=43)
    return str(p)


PATCH_KW = dict(patch_size=128, stride_size=64, batch_size=4, supertile=256)
TILE_KW = dict(patch_size=128, stride_size=128, batch_size=4, supertile=384,
               inference_mode="tile")


def _assert_maps(got, want, exact):
    np.testing.assert_array_equal(got[0], want[0])  # the mask
    for k in ("mean", "var", "count"):
        if exact:
            np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
        else:
            np.testing.assert_allclose(got[1][k], want[1][k], rtol=0,
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("model", ["oracle", "tiny"])
def test_patch_mode_dp_equals_serial(model, dp_slide, tmp_path, monkeypatch,
                                     capsys):
    """Grid-dp over four shards gives the serial maps (the overlap-add's
    f32 order aside) and the same mask, with every shard's forward the
    serial run's."""
    serial = _engine(_port(device="cpu"), dp_slide, tmp_path / "s",
                     monkeypatch, model=model, **PATCH_KW)
    capsys.readouterr()
    dp = _engine(_port(device=["cpu"] * 4, data_parallel=4), dp_slide,
                 tmp_path / "d", monkeypatch, model=model, **PATCH_KW)
    assert "4 device(s)" in capsys.readouterr().out
    _assert_maps(dp, serial, exact=False)
    assert serial[1]["mean"].max() > 0


def test_patch_mode_dp_matches_jax(dp_slide, tmp_path, monkeypatch):
    """The port's grid-dp (4 shards) against JAX's data_parallel=True run
    on its 8 devices, oracle model: the mask equal, the maps within
    1e-5 (tests/test_parallel.py:45-64's rule)."""
    from digipathai_tpu.engine.segmentation import getSegmentation as jseg

    want = _engine(jseg, dp_slide, tmp_path / "j", monkeypatch,
                   model="oracle", data_parallel=True, **PATCH_KW)
    got = _engine(_port(device=["cpu"] * 4, data_parallel=4), dp_slide,
                  tmp_path / "t", monkeypatch, model="oracle", **PATCH_KW)
    assert got[0].any()
    _assert_maps(got, want, exact=False)


@pytest.mark.parametrize("crf", [False, True], ids=["nocrf", "crf"])
def test_tile_round_robin_equals_serial(crf, tile_slide, tmp_path,
                                        monkeypatch):
    """Supertiles dealt over four shards (TinyUNet) give the serial maps
    bit for bit, with each supertile's CRF run on the device that
    computed it."""
    from digipathai_tpu_torch.ops import crf as tcrf

    kw = dict(model="tiny", crf=crf, **TILE_KW)
    if crf:
        kw["crf_opts"] = {"n_iters": 2, "bil_radius": 4}
    seen = []
    refine = tcrf.refine_tile

    def spy(*a, device=None, **k):
        seen.append(device)
        return refine(*a, device=device, **k)

    monkeypatch.setattr(tcrf, "refine_tile", spy)
    serial = _engine(_port(device="cpu"), tile_slide, tmp_path / "s",
                     monkeypatch, **kw)
    dp = _engine(_port(device=["cpu"] * 4, data_parallel=4), tile_slide,
                 tmp_path / "d", monkeypatch, **kw)
    _assert_maps(dp, serial, exact=True)
    assert bool(seen) == crf
    if crf:
        assert dp[1]["mean"].max() > 0


def test_tile_round_robin_matches_jax(tile_slide, tmp_path, monkeypatch):
    """The round-robin on four shards against JAX's tile run on its 8
    devices (tests/test_tile_mode.py:65-90's slide and plan), oracle
    model: the mask equal, the maps within 1e-5."""
    from digipathai_tpu.engine.segmentation import getSegmentation as jseg

    want = _engine(jseg, tile_slide, tmp_path / "j", monkeypatch,
                   model="oracle", data_parallel=True, **TILE_KW)
    got = _engine(_port(device=["cpu"] * 4, data_parallel=4), tile_slide,
                  tmp_path / "t", monkeypatch, model="oracle", **TILE_KW)
    assert got[0].any()
    _assert_maps(got, want, exact=False)


def test_spatial_shard(tile_slide, tmp_path, monkeypatch):
    """spatial_shard=True raises JAX's ValueError where JAX cannot shard
    (one device; a padded tile of 512 over 3 devices) and shards where it
    can (4 devices: the serial run's mask and maps, bit for bit for this
    pointwise model); "auto" takes the sharded step when fewer supertiles
    than devices are left (one tissue supertile on four devices)."""
    from digipathai_tpu_torch.engine import tile_infer

    kw = dict(model="oracle", **TILE_KW)
    with pytest.raises(ValueError, match="needs >1 device"):
        _engine(_port(device="cpu"), tile_slide, tmp_path / "a",
                monkeypatch, spatial_shard=True, **kw)
    with pytest.raises(ValueError, match="needs >1 device"):
        _engine(_port(device=["cpu"] * 3), tile_slide, tmp_path / "b",
                monkeypatch, spatial_shard=True, **kw)
    serial = _engine(_port(device="cpu"), tile_slide, tmp_path / "s",
                     monkeypatch, **kw)
    taken = []
    real = tile_infer.build_tile_step_sp
    monkeypatch.setattr(tile_infer, "build_tile_step_sp",
                        lambda *a, **k: taken.append(a[4]) or real(*a, **k))
    sharded = _engine(_port(device=["cpu"] * 4), tile_slide, tmp_path / "c",
                      monkeypatch, spatial_shard=True, **kw)
    assert len(taken) == 1 and len(taken[0]) == 4
    _assert_maps(sharded, serial, exact=True)
    # one tissue supertile on four devices: JAX's "auto" shards it
    mask, _ = _engine(_port(device=["cpu"] * 4), tile_slide,
                      tmp_path / "d", monkeypatch, spatial_shard="auto",
                      **{**kw, "supertile": 1024 - 128})
    assert mask.any() and len(taken) == 2
    # ... and deals round-robin when there are as many supertiles as
    # devices (four 384 px supertiles here)
    _engine(_port(device=["cpu"] * 4), tile_slide, tmp_path / "e",
            monkeypatch, spatial_shard="auto", **kw)
    assert len(taken) == 2


def test_dp_state_is_not_resumed_serially(dp_slide, tmp_path, monkeypatch):
    """The resume key holds the global batch: a serial run does not take
    up what a dp run of the same slide left, and a dp run of the same
    width does."""
    from digipathai_tpu_torch import getSegmentation

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    paths = {k: str(tmp_path / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    base = dict(img_path=dp_slide, quick=True, model="oracle", mode="breast",
                num_workers=2, resume=True, **paths, **PATCH_KW)
    getSegmentation(**base, device=["cpu"] * 2, data_parallel=2)
    state = next((tmp_path / "cache" / "memmaps").glob("*-stitch.json"))
    dp_key = state.read_text()
    progress = []
    getSegmentation(**base, device=["cpu"] * 2, data_parallel=2,
                    progress_cb=lambda d, t: progress.append(d))
    assert progress == [] and state.read_text() == dp_key  # all resumed
    getSegmentation(**base, device="cpu",
                    progress_cb=lambda d, t: progress.append(d))
    assert progress, "the serial run resumed the dp run's state"
    assert state.read_text() != dp_key


def test_server_data_parallel_reaches_a_dp_run(dp_slide, tmp_path,
                                               monkeypatch, capsys):
    """``--data-parallel 2`` and a device list through ``--engine-opt``
    reach getSegmentation, which runs two shards."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.server.cli import build_config

    cfg, _ = build_config(["--data-parallel", "2", "--engine-opt",
                           "device=['cpu', 'cpu', 'cpu']", str(tmp_path)])
    kw = cfg.engine_kwargs()
    assert kw["data_parallel"] == 2 and kw["device"] == ["cpu"] * 3
    cfg, _ = build_config(["--data-parallel", "true"])
    assert cfg.engine_kwargs() == {"data_parallel": True, "device": "cuda"}
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    capsys.readouterr()
    getSegmentation(dp_slide, quick=True, model="oracle", mode="breast",
                    probs_path=str(tmp_path / "p.tiff"),
                    mask_path=str(tmp_path / "m.tiff"),
                    uncertainty_path=str(tmp_path / "u.tiff"),
                    num_workers=2, **PATCH_KW,
                    **build_config(["--data-parallel", "2", "--engine-opt",
                                    "device=['cpu', 'cpu', 'cpu']"]
                                   )[0].engine_kwargs())
    assert "2 device(s)" in capsys.readouterr().out
