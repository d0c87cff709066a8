"""examples/train_torch.py: the port's fine-tuning drive on a synthetic slide.

``tests/test_train_example.py``'s two cases on the port's twin of
``examples/train.py`` (``--device cpu``), and a third: the weights it
saves into the port's cache load through ``weights.load_variables`` as
the trained module.  A fourth trains on a (1, 2, 2) mesh of four CPU
devices in one process (``--device cpu,cpu,cpu,cpu``).
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "train_torch.py")
TINY = ["--model", "tiny", "--patch", "64", "--batch", "2", "--steps", "4",
        "--lr", "1e-2", "--from-scratch", "--device", "cpu"]


@pytest.fixture(scope="module")
def gt_slide_pair(tmp_path_factory):
    from digipathai_tpu_torch.io.backend import write_pyramid

    from tests.fixtures import render_he_like

    d = tmp_path_factory.mktemp("train")
    img, tissue, lesion = render_he_like(1024, 768, seed=3)
    slide = str(d / "s.tiff")
    gt = str(d / "s-gt.tiff")
    write_pyramid(slide, img, compression="deflate")
    write_pyramid(gt, (lesion * 255).astype(np.uint8), compression="deflate")
    return slide, gt


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    for k in ("DPAI_COORDINATOR", "DPAI_NUM_PROCESSES", "DPAI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)


def _jax_deeplab_step_raises():
    """JAX's train step cannot train DeepLab: it applies the module with
    ``train=True`` and no dropout rng (ROADMAP.md §C)."""
    import flax
    import jax
    import jax.numpy as jnp

    from digipathai_tpu.models.registry import build_model
    from digipathai_tpu.training.losses import make_optimizer
    from digipathai_tpu.training.train import make_train_step

    module = build_model("deeplabv3").module
    x = jnp.zeros((2, 64, 64, 3), jnp.float32)
    v = jax.eval_shape(lambda k: module.init(k, x, train=False),
                       jax.random.PRNGKey(0))
    o = jax.eval_shape(make_optimizer().init, v["params"])
    with pytest.raises(flax.errors.InvalidRngError):
        jax.eval_shape(make_train_step(build_model("deeplabv3")), v, o, x,
                       jnp.zeros((2, 64, 64, 2), jnp.float32))


@pytest.mark.parametrize("model", ["tiny", "deeplabv3"])
def test_train_example_end_to_end(model, gt_slide_pair, tmp_path,
                                  monkeypatch):
    """Both on the CPU; DeepLab one step, with its dropout drawn from the
    example's generator, where JAX's step raises."""
    if model == "deeplabv3":
        _jax_deeplab_step_raises()
    slide, _gt = gt_slide_pair
    out = str(tmp_path / "ft.npz")
    argv = [*TINY, "--steps", "1"] if model != "tiny" else TINY
    monkeypatch.setattr(sys, "argv", ["train_torch.py", slide, *argv,
                                      "--model", model, "--out", out])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(EXAMPLE, run_name="__main__")
    assert exc.value.code == 0
    saved = np.load(out)
    assert ("Conv_0.kernel" if model == "tiny"
            else "custom_logits_semantic.kernel") in saved.files


def test_train_example_missing_gt_fails(tmp_path, monkeypatch):
    from digipathai_tpu_torch.io.backend import write_pyramid

    from tests.fixtures import render_he_like

    img, _, _ = render_he_like(512, 512, seed=1)
    slide = str(tmp_path / "nogt.tiff")
    write_pyramid(slide, img, compression="deflate")
    monkeypatch.setattr(sys, "argv", ["train_torch.py", slide, "--model",
                                      "tiny", "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(EXAMPLE, run_name="__main__")
    assert "ground truth" in str(exc.value)


def test_saved_weights_load_as_the_trained_module(gt_slide_pair):
    """With no ``--out`` the weights go to the port's cache
    (``converted/<family>_<model>.torch.npz``), and ``load_variables``
    gives the trained module's parameters and statistics exactly."""
    from digipathai_tpu_torch.models import weights
    from digipathai_tpu_torch.models.registry import build_model

    slide, _ = gt_slide_pair
    ns = runpy.run_path(EXAMPLE)
    state, out = ns["train"](ns["parse_args"]([slide, *TINY, "--mode",
                                               "liver"]))
    assert out == str(weights.converted_path("liver", "tiny"))
    assert state.step == 4 and not state.model.training
    fresh = build_model("tiny").init(64, seed=0)
    loaded = weights.load_variables(build_model("tiny"), "liver", "tiny")
    trained = state.model.state_dict()
    assert any(not torch.equal(fresh.state_dict()[k], v)
               for k, v in trained.items())
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_train_example_on_a_mesh(gt_slide_pair, tmp_path, capsys):
    """``--device cpu,cpu,cpu,cpu`` meshes four devices at (1, 2, 2) in one
    process, as ``examples/train.py`` meshes every local device: it prints
    the mesh, the loss falls, and the saved weights are the mesh's
    (``unshard``)."""
    import re

    from digipathai_tpu_torch.training.train import MeshState, unshard

    slide, _ = gt_slide_pair
    out = str(tmp_path / "mesh.npz")
    ns = runpy.run_path(EXAMPLE)
    argv = [a if a != "cpu" else "cpu,cpu,cpu,cpu" for a in TINY]
    state, saved = ns["train"](ns["parse_args"]([slide, *argv, "--out",
                                                 out]))
    text = capsys.readouterr().out
    assert "mesh: {'dp': 1, 'sp': 2, 'mp': 2}" in text, text
    losses = [float(v) for v in re.findall(r"loss (\S+)", text)]
    assert len(losses) == 2 and losses[-1] < losses[0], losses
    assert isinstance(state, MeshState) and state.step == 4
    assert saved == out
    model = unshard(state)
    loaded = np.load(out)
    assert sorted(loaded.files) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert np.array_equal(loaded[k], v.numpy()), k
