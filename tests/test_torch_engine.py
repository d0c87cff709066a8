"""The port's getSegmentation end to end on the CPU, against the JAX engine."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """The engine loads trained weights, downloading a missing .h5 unless
    DPAI_OFFLINE=1: no test reaches the network."""
    monkeypatch.setenv("DPAI_OFFLINE", "1")


REPO = Path(__file__).resolve().parents[1]
KW = dict(patch_size=128, stride_size=64, batch_size=8, mode="breast",
          supertile=512, num_workers=2)


def _run(engine, slide, out_dir, monkeypatch, **kw):
    """One engine run with its own cache; returns (mask, probs u8, maps)."""
    from digipathai_tpu.io.slide import Slide

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


def _torch_engine(**extra):
    from digipathai_tpu_torch import getSegmentation

    return lambda **kw: getSegmentation(**kw, device="cpu", **extra)


def test_oracle_matches_jax_engine(synthetic_slide, tmp_path, monkeypatch):
    from digipathai_tpu.engine.segmentation import getSegmentation as jax_seg
    from digipathai_tpu.utils.status import SegmentationStatus

    path, meta = synthetic_slide
    seen = []

    class Recording(SegmentationStatus):
        def __setitem__(self, k, v):
            if k == "status":
                seen.append(v)
            super().__setitem__(k, v)

    status = Recording()
    got = _run(_torch_engine(), path, tmp_path / "t", monkeypatch,
               model="oracle", status=status)
    want = _run(jax_seg, path, tmp_path / "j", monkeypatch, model="oracle")
    assert got[0].shape == (meta["width"], meta["height"])
    assert set(np.unique(got[0])) == {0, 255}
    np.testing.assert_array_equal(got[0], want[0])   # mask, bit for bit
    np.testing.assert_array_equal(got[1], want[1])   # u8 probability TIFF
    np.testing.assert_array_equal(got[2]["count"], want[2]["count"])
    np.testing.assert_allclose(got[2]["mean"], want[2]["mean"], rtol=0,
                               atol=1e-6)
    assert seen == ["Found Trained Models, Skipping download",
                    "Loading Trained weights", "Running segmentation",
                    "Saving Prediction Mask...",
                    "Saving Prediction Uncertanity..."]
    assert status["progress"] == 0


def test_tiny_bridged_matches_jax_engine(synthetic_slide, tmp_path,
                                         monkeypatch):
    """TinyUNet on the JAX engine's own seed-0 weights, bridged, with two
    TTA transforms so the variance plane is exercised; f32 maps within
    1e-4."""
    import jax

    from digipathai_tpu.engine.segmentation import getSegmentation as jax_seg
    from digipathai_tpu.models.registry import build_model as jax_build
    from digipathai_tpu_torch.models import registry
    from digipathai_tpu_torch.models.bridge import flax_to_torch

    path, _ = synthetic_slide
    tta = ["FLIP_LEFT_RIGHT", "ROTATE_90"]
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax_build("tiny", dtype=jnp.float32).init(128)))
    monkeypatch.setattr(registry.ModelBundle, "init",
                        lambda self, patch_size=256, seed=0: flax_to_torch(
                            variables, self.module))
    got = _run(_torch_engine(), path, tmp_path / "t", monkeypatch,
               model="tiny", compute_dtype=torch.float32, tta_list=tta)
    want = _run(jax_seg, path, tmp_path / "j", monkeypatch, model="tiny",
                compute_dtype=jnp.float32, tta_list=tta)
    assert got[2]["mean"].max() > 0
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2]["count"], want[2]["count"])


def test_resume_reproduces_finished_run(synthetic_slide, tmp_path,
                                        monkeypatch):
    path, _ = synthetic_slide
    calls = []
    first = _run(_torch_engine(), path, tmp_path, monkeypatch, model="oracle",
                 progress_cb=lambda d, t: calls.append(d))
    n_batches = len(calls)
    again = _run(_torch_engine(), path, tmp_path, monkeypatch, model="oracle",
                 resume=True, progress_cb=lambda d, t: calls.append(d))
    assert n_batches > 0 and len(calls) == n_batches  # nothing recomputed
    np.testing.assert_array_equal(again[0], first[0])
    for k in ("mean", "var", "count"):
        np.testing.assert_array_equal(again[2][k], first[2][k])


@pytest.mark.parametrize("inference_mode", ["patch", "tile"])
def test_fresh_rerun_refines_again(synthetic_slide, tmp_path, monkeypatch,
                                   inference_mode):
    """A fresh (resume=False) crf=True run in the cache where the same
    slide's last run finished its CRF starts its maps anew, so it must run
    the CRF again and give the same maps."""
    path, _ = synthetic_slide
    kw = dict(model="oracle", crf=True, stride_size=128,
              crf_opts={"n_iters": 2, "bil_radius": 4},
              inference_mode=inference_mode)
    runs = []
    for _ in range(2):
        status = {}
        runs.append(_run(_torch_engine(), path, tmp_path, monkeypatch,
                         status=status, **kw))
        assert "crf" in status["timings"], status
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    np.testing.assert_array_equal(runs[1][2]["mean"], runs[0][2]["mean"])


@pytest.fixture(scope="module")
def small_slide(tmp_path_factory):
    """A 256x192 synthetic slide: ten 64 px patches at stride 64, in two
    128 px supertiles."""
    from tests.fixtures import make_synthetic_slide

    path = tmp_path_factory.mktemp("small") / "small-slide.tiff"
    make_synthetic_slide(str(path), width=256, height=192, seed=0)
    return str(path)


SMALL = dict(patch_size=64, stride_size=64, batch_size=4, mode="breast",
             supertile=128, num_workers=1)


@pytest.mark.parametrize("kw", [
    {"quick": False},
    {"model": "inception", "inference_mode": "tile", "fused_stages": 5},
], ids=["ensemble", "inception-tile"])
def test_ensemble_and_inception_run(small_slide, tmp_path, monkeypatch, kw):
    """``quick=False`` (the 3-model ensemble, patch mode) and
    ``model="inception"`` (tile mode, its five decoder stages on
    fused_up_stage) run on the CPU with their seeded random weights."""
    from digipathai_tpu_torch import getSegmentation

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    status = {}
    paths = {k: str(tmp_path / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    mask = getSegmentation(small_slide, **paths, **SMALL, **kw,
                           status=status, device="cpu")
    assert mask.shape == (256, 192) and set(np.unique(mask)) <= {0, 255}
    assert status["weights"] == "random" and "infer" in status["timings"]


@pytest.mark.parametrize("kw,calibrated", [
    ({"quantized": "static"}, ["DenseNet121UNet"]),
    ({"quantized": "deeplabv3:static", "quick": False,
      "inference_mode": "tile"}, ["DeepLabV3Plus"]),
    ({"quantized": {"inception": "calib", "dense": True},
      "model": "inception"}, []),
    ({"fold_bn": True, "model": "inception", "inference_mode": "tile",
      "fused_stages": 5}, []),
    ({"fold_bn": True, "quantized": "dynamic", "model": "deeplabv3"}, []),
], ids=["static", "ensemble-deeplabv3-static-tile", "per-model-dict-calib",
        "fold_bn-inception-tile", "fold_bn-dynamic-deeplabv3"])
def test_quantized_and_fold_bn_run(small_slide, tmp_path, monkeypatch, kw,
                                   calibrated):
    """``quantized`` in its JAX forms and ``fold_bn`` run on the CPU in
    patch and tile mode (their parity with JAX is in test_torch_quant.py
    and test_torch_fold_bn.py); the static models alone are calibrated
    first."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.models import quant

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    seen = []
    real = quant.calibrate
    monkeypatch.setattr(quant, "calibrate", lambda m, xs: seen.append(
        type(m).__name__) or real(m, xs))
    paths = {k: str(tmp_path / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    status = {}
    mask = getSegmentation(small_slide, **paths, **{**SMALL, **kw},
                           status=status, device="cpu")
    assert mask.shape == (256, 192) and set(np.unique(mask)) <= {0, 255}
    assert "infer" in status["timings"] and seen == calibrated


@pytest.mark.parametrize("kw,item", [
    # data_parallel=2 runs (tests/test_torch_parallel.py), and so does the
    # spatially sharded tile step on two devices (item None: the run gives
    # the one-device run's mask; tests/test_torch_spatial.py); what is left
    # to refuse is JAX's ValueError where the padded tile does not split
    pytest.param({"data_parallel": 2, "device": ["cpu", "cpu"],
                  "inference_mode": "tile", "spatial_shard": True},
                 None, id="kw4-multi-device"),
    pytest.param({"data_parallel": 3, "device": ["cpu"] * 3,
                  "inference_mode": "tile", "spatial_shard": True},
                 "needs >1 device", id="kw5-tile-does-not-split"),
])
def test_unsupported_kwargs_raise(synthetic_slide, tmp_path, monkeypatch, kw,
                                  item):
    from digipathai_tpu_torch import getSegmentation

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path))
    run = {"model": "oracle", "device": "cpu", **kw}
    if item is not None:
        with pytest.raises(ValueError, match=item):
            getSegmentation(synthetic_slide[0], **run)
        return
    mask = getSegmentation(synthetic_slide[0], **run)
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "serial"))
    serial = getSegmentation(synthetic_slide[0], model="oracle",
                             device="cpu", inference_mode="tile")
    assert mask.any()
    np.testing.assert_array_equal(mask, serial)


def test_cuda_without_gpu_raises(synthetic_slide, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from digipathai_tpu_torch import getSegmentation

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        getSegmentation(synthetic_slide[0], model="oracle")


_NOT_LOADED = ("jax", "flax", "digipathai_tpu")


def test_no_jax_loaded(synthetic_slide, tmp_path):
    """The port runs the oracle engine in a fresh interpreter without ever
    loading jax, flax or the JAX package."""
    code = f"""
import sys
import numpy as np
import digipathai_tpu_torch
out = digipathai_tpu_torch.getSegmentation(
    {synthetic_slide[0]!r}, patch_size=128, stride_size=128, batch_size=8,
    model="oracle", mode="colon", supertile=512, num_workers=2,
    probs_path={str(tmp_path / "p.tiff")!r}, mask_path={str(tmp_path / "m.tiff")!r},
    uncertainty_path={str(tmp_path / "u.tiff")!r}, device="cpu")
assert out.shape == (2048, 1536), out.shape
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {_NOT_LOADED!r})
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ, "DPAI_CACHE": str(tmp_path / "cache"),
           "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_every_module_stands_alone(synthetic_slide, small_slide, tmp_path):
    """Importing every module of the port, a TinyUNet train step (serial,
    then on a four-device CPU mesh), running
    the oracle engine spatially sharded over two devices and with crf=True
    in patch and in tile mode, the 3-model ensemble (quick=False)
    in tile mode, and dense from a written .npz cache (folded, quantized
    static) loads no jax, flax or digipathai_tpu module."""
    code = f"""
import importlib, pkgutil, sys
import digipathai_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 30, names
for name in ("ops.stage_fused", "engine.tile_infer", "ops.resize",
             "models.inception_unet", "models.deeplabv3",
             "models.keras_names", "models.unet_decoder",
             "models.convert_h5", "models.fold_bn", "models.quant",
             "training.losses", "training.train", "parallel.distributed",
             "parallel.inference", "parallel.spatial", "ops.roi",
             "utils.metrics", "utils.viz", "parallel.mesh",
             "parallel.channels", "dryrun"):
    assert "digipathai_tpu_torch." + name in names, name
import torch
from digipathai_tpu_torch.models import registry
from digipathai_tpu_torch.training.train import init_state, make_train_step
b = registry.build_model("tiny")
state = init_state(b, 32, device="cpu")
loss = make_train_step()(state, torch.zeros(2, 32, 32, 3),
                         torch.ones(2, 32, 32, 2) / 2)
assert torch.isfinite(loss) and state.step == 1
from digipathai_tpu_torch.parallel.mesh import make_mesh
from digipathai_tpu_torch.training.train import shard_state, shard_train_step
mesh = make_mesh(devices=["cpu"] * 4)
step = shard_train_step(mesh)
loss = step(shard_state(state, mesh), torch.zeros(2, 64, 64, 3),
            torch.ones(2, 64, 64, 2) / 2)
step.close()
assert torch.isfinite(loss) and mesh.shape == {{"dp": 1, "sp": 2, "mp": 2}}
from digipathai_tpu_torch.models import registry, weights
m = registry.build_model("dense").init(64, seed=7)
weights.save_converted(m, weights.converted_path("colon", "dense"))
status = {{}}
out = pkg.getSegmentation(
    {small_slide!r}, patch_size=64, stride_size=64, batch_size=4,
    mode="colon", supertile=128, num_workers=1, fold_bn=True,
    quantized="static", status=status,
    probs_path={str(tmp_path / "p.tiff")!r},
    mask_path={str(tmp_path / "m.tiff")!r},
    uncertainty_path={str(tmp_path / "u.tiff")!r}, device="cpu")
assert out.shape == (256, 192) and "weights" not in status, status
out = pkg.getSegmentation(
    {small_slide!r}, patch_size=64, stride_size=64, batch_size=4,
    quick=False, mode="colon", supertile=128, num_workers=1,
    inference_mode="tile", fused_stages=5,
    probs_path={str(tmp_path / "p.tiff")!r},
    mask_path={str(tmp_path / "m.tiff")!r},
    uncertainty_path={str(tmp_path / "u.tiff")!r}, device="cpu")
assert out.shape == (256, 192), out.shape
out = pkg.getSegmentation(
    {synthetic_slide[0]!r}, patch_size=128, stride_size=128, batch_size=8,
    model="oracle", mode="colon", supertile=512, num_workers=2,
    inference_mode="tile", spatial_shard=True, device=["cpu"] * 2,
    probs_path={str(tmp_path / "p.tiff")!r},
    mask_path={str(tmp_path / "m.tiff")!r},
    uncertainty_path={str(tmp_path / "u.tiff")!r})
assert out.shape == (2048, 1536), out.shape
for mode in ("patch", "tile"):
    status = {{}}
    out = pkg.getSegmentation(
        {synthetic_slide[0]!r}, patch_size=128, stride_size=128, batch_size=8,
        model="oracle", mode="colon", supertile=512, num_workers=2, crf=True,
        crf_opts={{"n_iters": 2, "bil_radius": 4}}, status=status,
        inference_mode=mode, probs_path={str(tmp_path / "p.tiff")!r},
        mask_path={str(tmp_path / "m.tiff")!r},
        uncertainty_path={str(tmp_path / "u.tiff")!r}, device="cpu")
    assert out.shape == (2048, 1536), out.shape
    assert "crf" in status["timings"], status
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {_NOT_LOADED!r})
assert not loaded, loaded
print("ok")
"""
    env = {**os.environ, "DPAI_CACHE": str(tmp_path / "cache"),
           "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_server_cli_device_option():
    """The port's CLI passes --device (default cuda) to the engine."""
    from digipathai_tpu_torch.server.cli import build_config

    cfg, _ = build_config(["-s", "."])
    assert cfg.engine_kwargs()["device"] == "cuda"
    cfg, _ = build_config(["--device", "cpu", "--crf"])
    assert cfg.engine_kwargs()["device"] == "cpu"
    assert cfg.engine_kwargs()["crf"] is True


def test_server_runs_the_port(tmp_path, monkeypatch):
    """POST /segment on the port's server reaches the port's engine and the
    mask overlay is served."""
    import json
    import threading
    import time
    import urllib.request

    from digipathai_tpu_torch.server import ServerConfig, create_app, serve
    from tests.fixtures import make_synthetic_slide

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    d = tmp_path / "slides"
    d.mkdir()
    make_synthetic_slide(str(d / "colon-a.tiff"), 512, 384, seed=2)
    cfg = ServerConfig(slide_dir=str(d), viewer_only=False, model="oracle",
                       engine_extra={"device": "cpu", "num_workers": 2})
    httpd = serve(create_app(cfg), host="127.0.0.1", port=0, quiet=True)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_port}"

    def get(path, data=None):
        with urllib.request.urlopen(base + path, data=data, timeout=30) as r:
            return r.read()

    try:
        get("/colon-a.tiff")
        get("/segment", data=b"tissuetype=Colon")
        t0 = time.time()
        while (st := json.loads(get("/check_segment_status")))["status"] \
                not in ("Done", "Error") and time.time() - t0 < 120:
            time.sleep(0.2)
        assert st["status"] == "Done", st
        assert b'Width="512"' in get("/colon-a-dgai-mask.tiff.dzi")
        assert get("/colon-a-dgai-mask.tiff_files/9/0_0.jpeg")[:2] == b"\xff\xd8"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_predict_batch_matches_jax():
    """Ensemble x TTA mean/var of one batch, no stitching."""
    from digipathai_tpu.engine.infer import predict_batch as jp
    from digipathai_tpu.models.registry import build_model as jb
    from digipathai_tpu_torch.engine.infer import predict_batch as tp
    from digipathai_tpu_torch.models.registry import build_model as tb

    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    tta = ("DEFAULT", "FLIP_LEFT_RIGHT", "ROTATE_270")
    jbundle, tbundle = jb("oracle"), tb("oracle")
    want = jp([jbundle], [jbundle.init(16)], u8, tta_list=tta,
              compute_dtype=jnp.float32)
    got = tp([tbundle], [tbundle.init(16)], u8, tta_list=tta,
             compute_dtype=torch.float32, device="cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == (3, 16, 16, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
