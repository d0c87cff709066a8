"""Trained ``.h5`` checkpoints in the port: ``models/convert_h5.py`` and
``models/weights.py`` against the JAX package's converter and engine.

Each model's randomized flax tree is written in Keras's ``save_weights``
layout by ``tests/test_convert_full.py::emit_keras_h5``; the port loads it
into its module bit for bit as ``flax_to_torch`` of JAX's own conversion.
Nothing downloads: every test runs with ``DPAI_OFFLINE=1`` and a
``download`` that raises.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

MODELS = ("dense", "inception", "deeplabv3")
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    from digipathai_tpu.models import weights as jw
    from digipathai_tpu_torch.models import weights as tw

    def no_download(*a, **kw):
        raise AssertionError("a test reached download()")

    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(tw, "download", no_download)
    monkeypatch.setattr(jw, "download", no_download)


def _tree(name):
    from tests.torch_parity import model_variables, randomize

    return randomize(model_variables(name, 64), 3)


def write_dense_h5(mode, tree=None):
    """``tree`` (by default the randomized dense tree), written as
    ``mode``'s trained dense checkpoint under ``$DPAI_CACHE``; returns the
    tree."""
    from digipathai_tpu.models.weights import h5_path
    from tests.test_convert_full import emit_keras_h5

    tree = _tree("dense") if tree is None else tree
    p = h5_path(mode, "dense")
    p.parent.mkdir(parents=True, exist_ok=True)
    emit_keras_h5(p, tree)
    return tree


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each model's tree and its .h5."""
    from tests.test_convert_full import emit_keras_h5

    d = tmp_path_factory.mktemp("h5")
    out = {}
    for name in MODELS:
        tree = _tree(name)
        emit_keras_h5(d / f"{name}.h5", tree)
        out[name] = (tree, d / f"{name}.h5")
    return out


@pytest.mark.parametrize("name", MODELS)
def test_h5_loads_bit_for_bit(written, name, monkeypatch):
    """``load_variables`` fills the port's module from the .h5 exactly as
    ``flax_to_torch(keras_h5_to_flax(...))`` of JAX's converter on JAX's
    template, reports the same coverage, and writes a ``.npz`` cache that
    loads back the same."""
    from digipathai_tpu.models.convert_h5 import coverage_report as j_cov
    from digipathai_tpu.models.convert_h5 import keras_h5_to_flax as j_conv
    from digipathai_tpu_torch.models import weights
    from digipathai_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
    from digipathai_tpu_torch.models.convert_h5 import coverage_report
    from digipathai_tpu_torch.models.registry import build_model

    tree, h5 = written[name]
    dst = weights.h5_path("breast", name)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_bytes(h5.read_bytes())

    want = flax_to_torch(j_conv(str(h5), tree, strict=True),
                         build_model(name).module)
    status = {}
    got = weights.load_variables(build_model(name), "breast", name,
                                 status=status)
    assert "weights" not in status
    want, got = _state(want), _state(got)
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    template = torch_to_flax(build_model(name).module)  # names and shapes
    assert coverage_report(str(dst), template) == j_cov(str(h5), tree)
    cache = weights.converted_path("breast", name)
    assert cache.name == f"camelyon_{name}.torch.npz" and cache.exists()
    with np.load(cache) as z:
        assert set(z.files) == set(want)
    dst.unlink()  # the cache alone now
    again = _state(weights.load_variables(build_model(name), "breast", name))
    for k, v in want.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_shifted_auto_names_load_the_same(written, tmp_path):
    """A checkpoint saved after other Keras models were built names its
    unnamed layers ``conv2d_37`` where the module has ``conv2d``: the
    per-class offset is detected and undone."""
    from digipathai_tpu_torch.models.convert_h5 import (coverage_report,
                                                        keras_h5_to_flax)
    from tests.test_convert_full import emit_keras_h5

    tree = written["dense"][0]

    def shift(tree, by):
        out = {}
        for coll, layers in tree.items():
            out[coll] = {}
            for layer, leaves in layers.items():
                for cls in ("conv2d", "batch_normalization"):
                    if layer == cls or layer.startswith(cls + "_") and \
                            layer[len(cls) + 1:].isdigit():
                        i = 0 if layer == cls else int(layer[len(cls) + 1:])
                        layer = f"{cls}_{i + by[cls]}"
                out[coll][layer] = leaves
        return out

    p = tmp_path / "shifted.h5"
    emit_keras_h5(p, shift(tree, {"conv2d": 37, "batch_normalization": 12}))
    rep = coverage_report(str(p), tree)
    assert not rep["ours_only"] and not rep["h5_only"]
    got = keras_h5_to_flax(str(p), tree, strict=True)
    for coll in tree:
        for layer, leaves in tree[coll].items():
            for leaf, a in leaves.items():
                np.testing.assert_array_equal(got[coll][layer][leaf], a)


def test_shape_mismatch_raises(written, tmp_path):
    from digipathai_tpu_torch.models.convert_h5 import keras_h5_to_flax
    from tests.test_convert_full import emit_keras_h5

    tree = written["dense"][0]
    bad = {c: {k: dict(v) for k, v in layers.items()}
           for c, layers in tree.items()}
    bad["params"]["conv2d_3"]["kernel"] = np.zeros((3, 3, 5, 7), np.float32)
    p = tmp_path / "bad.h5"
    emit_keras_h5(p, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        keras_h5_to_flax(str(p), tree)


def test_unmatched_checkpoint_raises_ioerror(written):
    """More than 5 % of the layers missing from the checkpoint raises
    ``IOError`` through ``load_variables``; fewer warn."""
    from digipathai_tpu_torch.models import weights
    from digipathai_tpu_torch.models.registry import build_model
    from tests.test_convert_full import emit_keras_h5

    tree = written["dense"][0]
    layers = sorted(tree["params"])
    p = weights.h5_path("colon", "dense")
    p.parent.mkdir(parents=True, exist_ok=True)
    for drop, raises in ((layers[:2], False), (layers[::10], True)):
        part = {c: {k: v for k, v in ls.items() if k not in drop}
                for c, ls in tree.items()}
        emit_keras_h5(p, part)
        weights.converted_path("colon", "dense").unlink(missing_ok=True)
        if raises:
            with pytest.raises(IOError, match="unmatched"):
                weights.load_variables(build_model("dense"), "colon", "dense")
        else:
            with pytest.warns(UserWarning, match="not present"):
                weights.load_variables(build_model("dense"), "colon", "dense")


def test_offline_without_a_checkpoint():
    """No .h5 and DPAI_OFFLINE=1: no download; the seeded random init with
    ``status["weights"] = "random"``, or ``IOError`` when random weights
    are not allowed."""
    from digipathai_tpu_torch.models import weights
    from digipathai_tpu_torch.models.registry import build_model

    assert weights.ensure_h5("liver", "inception") is None
    status = {}
    with pytest.warns(UserWarning, match="RANDOM"):
        m = weights.load_variables(build_model("dense"), "liver", "dense",
                                   status=status)
    assert status["weights"] == "random"
    got = _state(m)
    for k, v in _state(build_model("dense").init(256, seed=0)).items():
        np.testing.assert_array_equal(got[k], v)
    with pytest.raises(IOError, match="allow_random=False"):
        weights.load_variables(build_model("dense"), "liver", "dense",
                               allow_random=False)


def test_cli_prefetch_fails_offline(capsys):
    from digipathai_tpu_torch.models import weights

    assert weights.main(["prefetch", "--mode", "colon", "--models",
                         "dense"]) == 1
    assert "colon/dense: FAILED" in capsys.readouterr().out
    assert weights.main(["pin", "--mode", "colon"]) == 1


def test_write_keras_h5_matches_emit(written, tmp_path):
    """The port's own writer (used where jax is absent) writes what the
    tests' ``emit_keras_h5`` writes."""
    import h5py

    from digipathai_tpu_torch.models.convert_h5 import write_keras_h5
    from tests.test_convert_full import emit_keras_h5

    tree = written["deeplabv3"][0]
    emit_keras_h5(tmp_path / "a.h5", tree)
    write_keras_h5(tmp_path / "b.h5", tree)

    def read(p):
        out = {}
        with h5py.File(p, "r") as f:
            out["layer_names"] = list(f.attrs["layer_names"])
            f.visititems(lambda n, o: out.__setitem__(n, np.asarray(o))
                         if hasattr(o, "shape") else out.__setitem__(
                             n, list(o.attrs.get("weight_names", []))))
        return out

    a, b = read(tmp_path / "a.h5"), read(tmp_path / "b.h5")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture(scope="module")
def small_slide(tmp_path_factory):
    from tests.fixtures import make_synthetic_slide

    path = tmp_path_factory.mktemp("small") / "h5-slide.tiff"
    make_synthetic_slide(str(path), width=256, height=192, seed=0)
    return str(path)


def _maps(cache):
    mm = Path(cache) / "memmaps"
    return {k: np.fromfile(next(mm.glob(f"*-{k}.dat")), np.float32)
            for k in ("mean", "var")}


def test_engine_dense_from_h5_matches_jax(written, small_slide, tmp_path,
                                          monkeypatch):
    """Dense loaded from one written .h5 through the JAX engine and the
    port's, in f32 with two TTA chains: the mean and var maps within 1e-4
    and the masks identical wherever |p - 0.3| > 1e-4."""
    from digipathai_tpu.engine.segmentation import getSegmentation as jseg
    from digipathai_tpu.models import registry as jreg
    from digipathai_tpu_torch import getSegmentation as tseg

    tree = None
    out = {}
    for tag in ("jax", "torch"):
        cache = tmp_path / tag / "cache"
        monkeypatch.setenv("DPAI_CACHE", str(cache))
        tree = write_dense_h5("colon", written["dense"][0])
        # JAX's template from shapes alone: its init runs a whole forward
        monkeypatch.setattr(jreg.ModelBundle, "init",
                            lambda self, patch_size, seed=0: tree)
        kw = dict(patch_size=64, stride_size=32, batch_size=8,
                  mode="colon", supertile=128, num_workers=1,
                  tta_list=["FLIP_LEFT_RIGHT"],
                  probs_path=str(tmp_path / tag / "p.tiff"),
                  mask_path=str(tmp_path / tag / "m.tiff"),
                  uncertainty_path=str(tmp_path / tag / "u.tiff"))
        status = {}
        if tag == "jax":
            mask = jseg(small_slide, **kw, data_parallel=False,
                        compute_dtype=jnp.float32, status=status)
        else:
            mask = tseg(small_slide, **kw, compute_dtype=torch.float32,
                        device="cpu", status=status)
        assert "weights" not in status
        out[tag] = np.asarray(mask), _maps(cache)
    (jm, jmaps), (tm, tmaps) = out["jax"], out["torch"]
    assert jmaps["var"].max() > 0
    for k in ("mean", "var"):
        np.testing.assert_allclose(tmaps[k], jmaps[k], rtol=0, atol=F32_TOL)
    sure = np.abs(jmaps["mean"].reshape(192, 256).T - 0.3) > 1e-4
    np.testing.assert_array_equal(tm[sure], jm[sure])
