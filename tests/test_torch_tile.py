"""The port's tile mode (engine/tile_infer.py and the engine's tile branch)
on the CPU, against the JAX package's."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """The engine loads trained weights, downloading a missing .h5 unless
    DPAI_OFFLINE=1: no test reaches the network."""
    monkeypatch.setenv("DPAI_OFFLINE", "1")


KW = dict(patch_size=128, stride_size=64, batch_size=8, mode="breast",
          supertile=512, num_workers=2, inference_mode="tile",
          data_parallel=False)
CRF_OPTS = {"n_iters": 2, "bil_radius": 4}  # small JAX graphs on the CPU


def _run(engine, slide, out_dir, monkeypatch, **kw):
    """One engine run with its own cache; returns (mask, probs u8, maps)."""
    from digipathai_tpu_torch.io.slide import Slide

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("DPAI_CACHE", str(out_dir / "cache"))
    paths = {k: str(out_dir / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    mask = np.asarray(engine(img_path=slide, **paths, **{**KW, **kw}))
    with Slide(paths["probs_path"]) as s:
        probs = np.asarray(s.read_level(0))
    mm = out_dir / "cache" / "memmaps"
    maps = {k: np.fromfile(next(mm.glob(f"*-{k}.dat")), np.float32)
            for k in ("mean", "var", "count")}
    return mask, probs, maps


def _torch_seg(**kw):
    from digipathai_tpu_torch import getSegmentation

    return getSegmentation(**kw, device="cpu")


def _jax_seg(**kw):
    from digipathai_tpu.engine.segmentation import getSegmentation

    return getSegmentation(**kw)


def _bridge_tiny(monkeypatch):
    """The port's TinyUNet takes the JAX engine's seed-0 weights."""
    from digipathai_tpu.models.registry import build_model as jax_build
    from digipathai_tpu_torch.models import registry
    from digipathai_tpu_torch.models.bridge import flax_to_torch

    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax_build("tiny", dtype=jnp.float32).init(128)))
    monkeypatch.setattr(registry.ModelBundle, "init",
                        lambda self, patch_size=256, seed=0: flax_to_torch(
                            variables, self.module))
    return variables


def test_fetch_window_matches_jax():
    """The cases of tests/test_tile_mode.py's fetch-window test: bbox
    compute windows and full-tile bucketed bboxes, exactly."""
    from digipathai_tpu.engine.tile_infer import fetch_window as jf
    from digipathai_tpu_torch.engine.tile_infer import fetch_window as tf

    S, halo = 4000, 64
    buckets = sorted({(S + 3) // 4, (S + 1) // 2, S})
    rng = np.random.default_rng(11)
    n = 0
    for _ in range(50):
        x0, y0 = rng.integers(0, S - 256, 2)
        c = np.stack([rng.integers(x0, x0 + 200, 8),
                      rng.integers(y0, y0 + 200, 8)], 1)
        b = 1024
        wx0 = min(max(0, int(c[:, 0].min()) - halo), S - b)
        wy0 = min(max(0, int(c[:, 1].min()) - halo), S - b)
        args = (c, 0, 0, S, halo, buckets, wx0, wy0, (b, b))
        assert tf(*args) == jf(*args)
        n += 1
    for _ in range(50):
        x0, y0 = rng.integers(0, S - 300, 2)
        c = np.stack([rng.integers(x0, x0 + 280, 8),
                      rng.integers(y0, y0 + 280, 8)], 1)
        ox, oy = int(rng.integers(0, 64)), int(rng.integers(0, 64))
        args = (c + [ox, oy], ox, oy, S, halo, buckets, 0, 0, (S, S))
        assert tf(*args) == jf(*args)
        n += 1
    assert n == 100


@pytest.mark.parametrize("tta_batch", [1, 2])
def test_model_tile_steps_match_jax(tta_batch):
    """Bridged TinyUNet plus the oracle, three TTA chains: per-model sums
    and sums of squares and the combined mean/var within 1e-5."""
    from digipathai_tpu.engine.tile_infer import build_model_tile_steps as jb
    from digipathai_tpu.models.registry import build_model as jbuild
    from digipathai_tpu_torch.engine.tile_infer import (
        build_model_tile_steps as tb)
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tbuild

    tta = ["DEFAULT", "FLIP_LEFT_RIGHT", "ROTATE_90"]
    jbundles = [jbuild("tiny", dtype=jnp.float32), jbuild("oracle")]
    jvars = tuple(b.init(64) for b in jbundles)
    tbundles = [tbuild("tiny", dtype=torch.float32), tbuild("oracle")]
    tvars = (flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(jvars[0])),
                           tbundles[0].module).eval(),
             tbundles[1].init(64))
    img = np.random.default_rng(5).integers(0, 255, (192, 192, 3),
                                            dtype=np.uint8)
    jsteps, jcombine, jn = jb(jbundles, tta, 128, 32,
                              compute_dtype=jnp.float32, tta_batch=tta_batch)
    tsteps, tcombine, tn = tb(tbundles, tta, 128, 32,
                              compute_dtype=torch.float32,
                              tta_batch=tta_batch, device="cpu")
    assert tn == jn == 6
    want = [s(v, jnp.asarray(img)) for s, v in zip(jsteps, jvars)]
    got = [s(v, img) for s, v in zip(tsteps, tvars)]
    for (gs, gq), (ws, wq) in zip(got, want):
        assert tuple(gs.shape) == (128, 128)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
        np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-5)
    gm, gv = tcombine([g[0] for g in got], [g[1] for g in got])
    wm, wv = jcombine([w[0] for w in want], [w[1] for w in want])
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    assert gv.min() >= 0


def test_tile_step_matches_jax():
    """The one-step form (every model x TTA prediction in one call): mean
    and var of the bridged TinyUNet plus the oracle within 1e-5 of JAX's,
    and equal to the per-model steps' combine."""
    from digipathai_tpu.engine.tile_infer import build_tile_step as jstep
    from digipathai_tpu.models.registry import build_model as jbuild
    from digipathai_tpu_torch.engine.tile_infer import (
        build_model_tile_steps, build_tile_step)
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tbuild

    tta = ["DEFAULT", "ROTATE_180"]
    jbundles = [jbuild("tiny", dtype=jnp.float32), jbuild("oracle")]
    jvars = tuple(b.init(64) for b in jbundles)
    tbundles = [tbuild("tiny", dtype=torch.float32), tbuild("oracle")]
    tvars = (flax_to_torch(jax.tree_util.tree_map(np.asarray, dict(jvars[0])),
                           tbundles[0].module).eval(),
             tbundles[1].init(64))
    img = np.random.default_rng(6).integers(0, 255, (192, 192, 3),
                                            dtype=np.uint8)
    wm, wv = jstep(jbundles, tta, 128, 32, compute_dtype=jnp.float32)(
        jvars, jnp.asarray(img))
    gm, gv = build_tile_step(tbundles, tta, 128, 32,
                             compute_dtype=torch.float32, device="cpu")(
        tvars, img)
    assert tuple(gm.shape) == tuple(gv.shape) == (128, 128)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    steps, combine, _ = build_model_tile_steps(
        tbundles, tta, 128, 32, compute_dtype=torch.float32, device="cpu")
    sums = [s(v, img) for s, v in zip(steps, tvars)]
    cm, cv = combine([s for s, _ in sums], [q for _, q in sums])
    np.testing.assert_allclose(cm.numpy(), gm.numpy(), atol=1e-6)
    np.testing.assert_allclose(cv.numpy(), gv.numpy(), atol=1e-6)


def test_oracle_tile_engine_matches_jax(synthetic_slide, tmp_path,
                                        monkeypatch):
    path, meta = synthetic_slide
    got = _run(_torch_seg, path, tmp_path / "t", monkeypatch, model="oracle")
    want = _run(_jax_seg, path, tmp_path / "j", monkeypatch, model="oracle")
    assert got[0].shape == (meta["width"], meta["height"])
    assert got[0].any()
    np.testing.assert_array_equal(got[0], want[0])   # mask, bit for bit
    np.testing.assert_array_equal(got[1], want[1])   # u8 probability TIFF
    np.testing.assert_array_equal(got[2]["count"], want[2]["count"])
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=0, atol=1e-6)


def test_tiny_bridged_tile_engine_matches_jax(synthetic_slide, tmp_path,
                                              monkeypatch):
    """TinyUNet on the JAX engine's weights with two TTA transforms, so
    the variance plane is exercised; f32 maps within 1e-4."""
    path, _ = synthetic_slide
    _bridge_tiny(monkeypatch)
    tta = ["FLIP_LEFT_RIGHT", "ROTATE_90"]
    got = _run(_torch_seg, path, tmp_path / "t", monkeypatch, model="tiny",
               compute_dtype=torch.float32, tta_list=tta)
    want = _run(_jax_seg, path, tmp_path / "j", monkeypatch, model="tiny",
                compute_dtype=jnp.float32, tta_list=tta)
    assert got[2]["mean"].max() > 0 and got[2]["var"].max() > 0
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2]["count"], want[2]["count"])


def test_bbox_compute_exact_for_oracle(tmp_path, monkeypatch):
    """A sparse supertile runs its forward on a small compute bucket, and
    the pointwise oracle gives the identical map either way."""
    from digipathai_tpu_torch.engine import tile_infer
    from digipathai_tpu_torch.io.backend import write_pyramid

    img = np.full((1536, 1536, 3), 245, np.uint8)
    blob = np.random.default_rng(7).integers(-20, 20, (120, 120, 3))
    img[600:720, 600:720] = np.clip(
        np.array([170, 90, 160]) + blob, 0, 255).astype(np.uint8)
    p = str(tmp_path / "sparse.tiff")
    write_pyramid(p, img, compression="jpeg", quality=92, mpp=0.5)
    sizes = []
    orig = tile_infer.build_model_tile_steps

    def spy(bundles, tta, tile, halo, **kw):
        sizes.append(tile)
        return orig(bundles, tta, tile, halo, **kw)

    monkeypatch.setattr(tile_infer, "build_model_tile_steps", spy)
    outs = {}
    for bbox in (True, False):
        outs[bbox] = _run(_torch_seg, p, tmp_path / f"bb{bbox}", monkeypatch,
                          model="oracle", stride_size=128, supertile=1536,
                          tile_bbox_compute=bbox)
    assert outs[True][0].any()
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(outs[True][2][k], outs[False][2][k])
    assert min(sizes) < 1536 and max(sizes) == 1536, sizes


def test_oracle_tile_crf_matches_jax(synthetic_slide, tmp_path, monkeypatch):
    """Tile mode's per-supertile CRF at flush: f32 maps within 1e-4 of the
    JAX engine's."""
    path, _ = synthetic_slide
    kw = dict(model="oracle", crf=True, crf_opts=CRF_OPTS,
              compute_dtype="float32")
    got = _run(_torch_seg, path, tmp_path / "t", monkeypatch, **kw)
    want = _run(_jax_seg, path, tmp_path / "j", monkeypatch,
                **{**kw, "compute_dtype": jnp.float32})
    raw = _run(_torch_seg, path, tmp_path / "r", monkeypatch, model="oracle",
               compute_dtype="float32")
    assert np.abs(got[2]["mean"] - raw[2]["mean"]).max() > 1e-2  # refined
    np.testing.assert_allclose(got[2]["mean"], want[2]["mean"], rtol=0,
                               atol=1e-4)


def test_interleaved_crf_equals_post_pass(tmp_path, monkeypatch):
    """The CRF at each supertile's flush equals the serial post-pass over
    the unrefined maps bit for bit (both run ops.crf.refine_tile), and the
    run records a 'crf' timing stage."""
    from tests.fixtures import make_synthetic_slide
    from digipathai_tpu_torch.io.slide import Slide
    from digipathai_tpu_torch.io.tiff_py import TiffReader
    from digipathai_tpu_torch.ops.crf import refine_slide_crf

    p = str(tmp_path / "ov-slide.tiff")
    make_synthetic_slide(p, 640, 512, seed=47)  # 2x2 grid with edge tiles
    common = dict(model="oracle", stride_size=128, batch_size=4,
                  mode="colon", supertile=384, save_float_probs=True,
                  crf_opts=CRF_OPTS)

    def read_f32(path):
        with TiffReader(path) as r:
            return np.asarray(r.read_whole(0), np.float32).squeeze()

    status = {}
    _run(_torch_seg, p, tmp_path / "a", monkeypatch, crf=True, status=status,
         **common)
    _run(_torch_seg, p, tmp_path / "b", monkeypatch, crf=False, **common)
    refined = read_f32(str(tmp_path / "a" / "probs_path.tiff.f32.tiff"))
    raw = read_f32(str(tmp_path / "b" / "probs_path.tiff.f32.tiff"))
    assert not np.array_equal(refined, raw)
    assert "crf" in status["timings"]
    with Slide(p) as slide:
        refine_slide_crf(slide, raw, supertile=384, device="cpu", **CRF_OPTS)
    np.testing.assert_array_equal(refined, raw)


def test_tile_resume_recomputes_nothing(synthetic_slide, tmp_path,
                                        monkeypatch):
    path, _ = synthetic_slide
    calls = []
    first = _run(_torch_seg, path, tmp_path, monkeypatch, model="oracle",
                 progress_cb=lambda d, t: calls.append(d))
    n_groups = len(calls)
    again = _run(_torch_seg, path, tmp_path, monkeypatch, model="oracle",
                 resume=True, progress_cb=lambda d, t: calls.append(d))
    assert n_groups > 0 and len(calls) == n_groups  # nothing recomputed
    np.testing.assert_array_equal(again[0], first[0])
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(again[2][k], first[2][k])


def test_dense_tile_engine_runs_fused_stages(tmp_path, monkeypatch):
    """Dense tile mode with fused_stages=5: each supertile forward runs its
    five decoder stages through fused_up_stage (the plain version on the
    CPU), and patch mode, at batch > 1, runs none."""
    from tests.fixtures import make_synthetic_slide
    from digipathai_tpu_torch.ops import stage_fused

    p = str(tmp_path / "d-slide.tiff")
    make_synthetic_slide(p, 256, 192, seed=5)
    calls = []
    real = stage_fused.fused_up_stage

    def counting(y, *a, **k):
        calls.append(tuple(y.shape))
        return real(y, *a, **k)

    monkeypatch.setattr(stage_fused, "fused_up_stage", counting)
    groups = []
    kw = dict(model="dense", patch_size=64, stride_size=64, batch_size=4,
              supertile=96, fused_stages=5)
    out = _run(_torch_seg, p, tmp_path / "t", monkeypatch,
               progress_cb=lambda d, t: groups.append(d), **kw)
    assert out[0].shape == (256, 192)
    assert len(groups) > 0 and len(calls) == 5 * len(groups)
    # the 160^2 tile (96 + a 32 px halo on each side), stage by stage
    assert calls[:5] == [(1, 5, 5, 1024), (1, 10, 10, 320),
                         (1, 20, 20, 256), (1, 40, 40, 128), (1, 80, 80, 96)]
    calls.clear()
    _run(_torch_seg, p, tmp_path / "p", monkeypatch,
         **{**kw, "inference_mode": "patch"})
    assert calls == []


@pytest.mark.parametrize("kw,match", [
    ({"patch_size": 100, "supertile": 300}, "divisible"),
    ({"spatial_shard": True}, "spatial_shard=True"),
])
def test_tile_mode_raises(synthetic_slide, tmp_path, monkeypatch, kw, match):
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path))
    with pytest.raises(ValueError, match=match):
        _torch_seg(img_path=synthetic_slide[0], **{**KW, "model": "oracle",
                                                   **kw},
                   probs_path=str(tmp_path / "p.tiff"),
                   mask_path=str(tmp_path / "m.tiff"),
                   uncertainty_path=str(tmp_path / "u.tiff"))
