"""The 3-model ensemble (``quick=False``): dense, inception and deeplabv3.

The port's ``predict_batch`` with the three bridged models and two TTA
chains against ``digipathai_tpu/engine/infer.py::predict_batch`` in f32,
then ``getSegmentation(quick=False, device="cpu")`` on a small slide in
patch and tile mode, with DeepLab rebuilt for ``tile_local_aspp``.
"""

from pathlib import Path
from unittest import mock

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


ENSEMBLE = ("dense", "inception", "deeplabv3")
KW = dict(patch_size=64, stride_size=64, batch_size=4, mode="breast",
          num_workers=1)


@pytest.fixture(scope="module")
def trees():
    """One randomized flax tree per model (shapes by ``jax.eval_shape``)."""
    from tests.torch_parity import (dense_variables, model_variables,
                                    randomize)

    t = {"dense": randomize(dense_variables(64, 0), 0),
         "inception": randomize(model_variables("inception", 64, 0), 1),
         "deeplabv3": randomize(model_variables("deeplabv3", 64, 0), 2)}
    t["deeplabv3"]["params"]["custom_logits_semantic"]["kernel"] *= 20.0
    return t


@pytest.fixture(scope="module")
def small_slide(tmp_path_factory):
    """A 256x192 synthetic slide: ten 64 px patches at stride 64."""
    from tests.fixtures import make_synthetic_slide

    path = tmp_path_factory.mktemp("ensemble") / "small-slide.tiff"
    make_synthetic_slide(str(path), width=256, height=192, seed=0)
    return str(path)


def test_predict_batch_matches_jax(trees):
    """Ensemble x TTA mean and variance of one batch, f32: each JAX apply
    jitted (the same forward as predict_batch's eager one), 1e-4.
    Measured with torch 2.13 (CPU): mean 7.2e-7, var 2.4e-7."""
    from digipathai_tpu.engine.infer import predict_batch as jp
    from digipathai_tpu.models.registry import build_model as jb
    from digipathai_tpu_torch.engine.infer import predict_batch as tp
    from digipathai_tpu_torch.models.bridge import flax_to_torch
    from digipathai_tpu_torch.models.registry import build_model as tb

    class Jitted:
        def __init__(self, name):
            self.apply = jax.jit(jb(name, dtype=jnp.float32).apply)

    u8 = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    tta = ("DEFAULT", "FLIP_LEFT_RIGHT")
    want = jp([Jitted(n) for n in ENSEMBLE], [trees[n] for n in ENSEMBLE],
              u8, tta_list=tta, compute_dtype=jnp.float32)
    bundles = [tb(n, dtype=torch.float32) for n in ENSEMBLE]
    modules = [flax_to_torch(trees[b.name], b.module).eval()
               for b in bundles]
    got = tp(bundles, modules, u8, tta_list=tta, compute_dtype=torch.float32,
             device="cpu")
    assert float(np.asarray(want[1]).max()) > 1e-4  # the models disagree
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 64, 64, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


@pytest.fixture()
def bridged(trees, monkeypatch):
    """Every bundle's ``init`` loads its model's flax tree, as trained
    weights would load; returns the calls the engine made to
    ``build_step`` and ``run_tile_inference``."""
    from digipathai_tpu_torch.engine import infer, segmentation, tile_infer
    from digipathai_tpu_torch.models import registry
    from digipathai_tpu_torch.models.bridge import flax_to_torch

    monkeypatch.setattr(registry.ModelBundle, "init",
                        lambda self, patch_size=256, seed=0: flax_to_torch(
                            trees[self.name], self.module).eval())
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append((fn.__name__, a, kw))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(segmentation, "build_step", spy(infer.build_step))
    monkeypatch.setattr(tile_infer, "run_tile_inference",
                        spy(tile_infer.run_tile_inference))
    return calls


def _deeplab(bundles, variables):
    (i,) = [i for i, b in enumerate(bundles) if b.name == "deeplabv3"]
    return bundles[i], variables[i]


@pytest.mark.parametrize("inference_mode", ["patch", "tile"])
def test_quick_false_runs_the_ensemble(small_slide, tmp_path, monkeypatch,
                                       bridged, trees, inference_mode):
    """Three TIFFs, the reference's status strings, a mask of (X, Y), and
    a variance over the three models.  In tile mode (supertile 128, a
    multiple of the 64 px patch) DeepLab runs with 64 px pooling windows on
    its own weights (``tile_local_aspp``); in patch mode with the global
    pool."""
    from digipathai_tpu_torch import Slide, getSegmentation
    from digipathai_tpu_torch.utils.status import SegmentationStatus

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    seen = []

    class Recording(SegmentationStatus):
        def __setitem__(self, k, v):
            if k == "status":
                seen.append(v)
            super().__setitem__(k, v)

    paths = {k: str(tmp_path / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    status = Recording()
    mask = getSegmentation(small_slide, **paths, **KW, quick=False,
                           supertile=128, inference_mode=inference_mode,
                           fused_stages=5, status=status, device="cpu")
    assert mask.shape == (256, 192) and set(np.unique(mask)) <= {0, 255}
    for p in paths.values():
        with Slide(p) as s:
            assert s.dimensions == (256, 192)
    assert seen == ["Downloading Trained Models", "Loading Trained weights",
                    "Running segmentation", "Saving Prediction Mask...",
                    "Saving Prediction Uncertanity..."]
    assert status["weights"] == "random" and status["progress"] == 0
    (name, args, _), = bridged
    if inference_mode == "patch":
        assert name == "build_step"
        bundles = args[0]
        assert [b.name for b in bundles] == list(ENSEMBLE)
        assert _deeplab(bundles, bundles)[0].module.aspp_pool_window == 0
    else:
        assert name == "run_tile_inference"
        bundles, variables = args[2], args[3]
        assert [b.name for b in bundles] == list(ENSEMBLE)
        b, m = _deeplab(bundles, variables)
        assert b.module is m and m.aspp_pool_window == 64
        want = trees["deeplabv3"]["params"]["aspp1_pointwise"]["kernel"]
        np.testing.assert_array_equal(
            m.aspp1_pointwise.kernel.detach().numpy(), want)
        dense, inception = variables[0], variables[1]
        assert dense.fused_stages == inception.fused_stages == 5
    mm = Path(tmp_path / "cache" / "memmaps")
    var = np.fromfile(next(mm.glob("*-var.dat")), np.float32)
    mean = np.fromfile(next(mm.glob("*-mean.dat")), np.float32)
    assert var.max() > 0 and 0 <= mean.min() and mean.max() <= 1


def test_tile_local_aspp_needs_whole_patches(small_slide, tmp_path,
                                             monkeypatch, bridged):
    """With supertile % patch_size != 0 (96 and 64), or with
    tile_local_aspp=False, DeepLab keeps its global pool in tile mode, as
    in JAX."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.engine import tile_infer

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    paths = {k: str(tmp_path / f"{k}.tiff")
             for k in ("probs_path", "mask_path", "uncertainty_path")}
    for supertile, local in ((96, True), (128, False)):
        with mock.patch.object(tile_infer, "run_tile_inference",
                               side_effect=stop) as spy, \
                pytest.raises(Stop):
            getSegmentation(small_slide, **paths, **KW, quick=False,
                            supertile=supertile, inference_mode="tile",
                            tile_local_aspp=local, device="cpu")
        b, m = _deeplab(spy.call_args.args[2], spy.call_args.args[3])
        assert b.module.aspp_pool_window == m.aspp_pool_window == 0
