"""BatchNorm folding in the port (``models/fold_bn.py``) against the JAX
package's ``fold_batchnorm``, for all three models.

Each model's flax tree has random BatchNorm statistics and affines, so every
fold is exercised.  The port's fold pairs the same layers (the same count
``n``), writes the same leaves, and its folded f32 forward stays with the
unfolded one (JAX's bound, ``tests/test_fold_bn.py``) and with JAX's folded
forward.
"""

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(2)

MODELS = ("dense", "inception", "deeplabv3")
LEAF_TOL = 1e-6     # folded leaves, port vs JAX
FOLD_TOL = 2e-4     # folded vs unfolded forward (tests/test_fold_bn.py)
F32_TOL = 1e-4      # port vs JAX, folded f32 forward


@pytest.fixture(scope="module")
def case():
    from tests.torch_parity import model_variables, randomize

    trees = {name: randomize(model_variables(name, 64), i + 5)
             for i, name in enumerate(MODELS)}
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    return trees, x


def _leaves(tree):
    return {(c, layer, leaf): np.asarray(a)
            for c, layers in tree.items() for layer, leaves in layers.items()
            for leaf, a in leaves.items()}


def _forward(module, x):
    with torch.inference_mode():
        return module(torch.from_numpy(x))[..., 1].float().numpy()


@pytest.mark.parametrize("name", MODELS)
def test_fold_matches_jax(case, name):
    from digipathai_tpu.models.fold_bn import fold_batchnorm as j_fold
    from digipathai_tpu.models.registry import build_model as j_build
    from digipathai_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
    from digipathai_tpu_torch.models.fold_bn import fold_batchnorm, fold_module
    from digipathai_tpu_torch.models.registry import build_model

    trees, x = case
    tree = trees[name]
    want, n_want = j_fold(tree)
    want = jax.tree_util.tree_map(np.asarray, want)
    got, n = fold_batchnorm(tree)
    assert n == n_want and n >= {"dense": 11, "inception": 90,
                                 "deeplabv3": 60}[name]
    gl, wl = _leaves(got), _leaves(want)
    assert gl.keys() == wl.keys()
    for k, v in wl.items():
        np.testing.assert_allclose(gl[k], v, rtol=0, atol=LEAF_TOL,
                                   err_msg=str(k))

    # in place on the module, after a forward: its prepared operands are
    # rebuilt, so it gives what a module loaded with the folded tree gives
    plain = flax_to_torch(tree, build_model(name, dtype=torch.float32)
                          .module).eval()
    y0 = _forward(plain, x)
    assert fold_module(plain) == n
    y1 = _forward(plain, x)
    fresh = flax_to_torch(got, build_model(name, dtype=torch.float32)
                          .module).eval()
    np.testing.assert_array_equal(y1, _forward(fresh, x))
    for k, v in _leaves(torch_to_flax(plain)).items():
        np.testing.assert_array_equal(v, gl[k].astype(np.float32))
    np.testing.assert_allclose(y1, y0, rtol=0, atol=FOLD_TOL)

    b = j_build(name, dtype=np.float32)
    y_jax = np.asarray(jax.jit(b.apply)(want, x))[..., 1]
    np.testing.assert_allclose(y1, y_jax, rtol=0, atol=F32_TOL)


def test_no_batch_stats_is_left_alone():
    from digipathai_tpu_torch.models.fold_bn import fold_module
    from digipathai_tpu_torch.models.registry import build_model

    for name in ("tiny", "oracle"):
        m = build_model(name).init(64)
        before = {k: v.clone() for k, v in m.state_dict().items()}
        assert fold_module(m) == 0
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[k])


def test_engine_fold_bn_runs(tmp_path, monkeypatch):
    """``getSegmentation(fold_bn=True)`` folds the loaded weights: the maps
    stay within FOLD_TOL of the unfolded run's (f32, tile mode with fused
    stages).  The fold happens at load, before the mode matters; patch
    mode folds in ``test_torch_engine.py::test_quantized_and_fold_bn_run``
    and ``test_every_module_stands_alone``."""
    from digipathai_tpu_torch import getSegmentation
    from digipathai_tpu_torch.models import fold_bn
    from tests.fixtures import make_synthetic_slide

    monkeypatch.setenv("DPAI_OFFLINE", "1")
    slide = str(tmp_path / "fold-slide.tiff")
    make_synthetic_slide(slide, 256, 192, seed=0)
    folds = []
    real = fold_bn.fold_module
    monkeypatch.setattr(fold_bn, "fold_module",
                        lambda m: folds.append(real(m)) or folds[-1])
    maps = {}
    for fold in (False, True):
        cache = tmp_path / f"tile-{fold}"
        monkeypatch.setenv("DPAI_CACHE", str(cache))
        getSegmentation(
            slide, patch_size=64, stride_size=64, batch_size=4,
            mode="colon", supertile=128, num_workers=1, fold_bn=fold,
            inference_mode="tile", fused_stages=5,
            compute_dtype=torch.float32, device="cpu",
            probs_path=str(cache / "p.tiff"),
            mask_path=str(cache / "m.tiff"),
            uncertainty_path=str(cache / "u.tiff"))
        maps[fold] = np.fromfile(next((cache / "memmaps").glob(
            "*-mean.dat")), np.float32)
    assert maps[True].max() > 0
    np.testing.assert_allclose(maps[True], maps[False], rtol=0,
                               atol=FOLD_TOL)
    assert folds == [11]  # the dense stem and the ten decoder blocks
