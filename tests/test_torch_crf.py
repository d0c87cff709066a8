"""The port's CRF (ops/crf.py and the engine's post-pass) against the JAX
package, on the CPU in float32.

Inputs are made with numpy from a seed and handed to both.  The bilateral
message bound is the Pallas kernel's, 2e-5 (tests/test_pallas.py); the
mean-field bounds are 1e-5 (only summation order and exp/softmax rounding
differ, over at most two iterations).  Windows and iteration counts stay
small so that JAX's CPU compiles stay cheap.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from digipathai_tpu.ops import crf as jcrf
from digipathai_tpu.ops.pallas.bilateral import bilateral_message_pallas
from digipathai_tpu_torch.ops import crf as tcrf

torch.set_num_threads(2)

MSG_BOUND = 2e-5   # tests/test_pallas.py
MF_BOUND = 1e-5
CRF_OPTS = {"n_iters": 2, "bil_radius": 4}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _sentinel_case(rng):
    """A bucket-padded grid: pad cells carry _PAD_COLOR (and a cell-mean
    dilution of it) and zero q, as production_bilateral_message sees them."""
    h, w = 40, 56
    img = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    q = rng.random((h, w, 2)).astype(np.float32)
    img[30:] = tcrf._PAD_COLOR
    img[:, 44:] = tcrf._PAD_COLOR
    img[29, :44] = tcrf._PAD_COLOR / 64  # a straddling cell's mean
    q[30:] = 0.0
    q[:, 44:] = 0.0
    return q, img, 5


@pytest.mark.parametrize("case", [(50, 40, 3), (70, 90, 10), (64, 300, 5),
                                  "sentinel"])
def test_bilateral_plain_matches_jax(case):
    """The plain message against bilateral_message_pallas(interpret=True)
    and, where the unrolled jit stays cheap (r <= 5), against JAX's own
    _bilateral_message (tests/test_pallas.py holds the two JAX versions to
    each other at r = 10)."""
    rng = np.random.default_rng(5)
    if case == "sentinel":
        q, img, r = _sentinel_case(rng)
    else:
        h, w, r = case
        img = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
        q = rng.random((h, w, 2)).astype(np.float32)
    got = tcrf._bilateral_message(_t(q), _t(img), 5.0, 20.0, r).numpy()
    assert np.isfinite(got).all()
    pallas = np.asarray(bilateral_message_pallas(
        jnp.asarray(q), jnp.asarray(img), 5.0, 20.0, r=r, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=MSG_BOUND)
    if r <= 5:
        plain = jax.jit(functools.partial(
            jcrf._bilateral_message, sigma_xy=5.0, sigma_rgb=20.0, radius=r))
        want = np.asarray(plain(jnp.asarray(q), jnp.asarray(img)))
        np.testing.assert_allclose(got, want, rtol=0, atol=MSG_BOUND)
    if case == "sentinel":
        # valid pixels see no pad neighbour: the message equals the
        # unpadded grid's
        crop = tcrf._bilateral_message(_t(q[:29, :44]), _t(img[:29, :44]),
                                       5.0, 20.0, r).numpy()
        np.testing.assert_allclose(got[:29, :44], crop, rtol=0, atol=1e-6)


def test_bilateral_wrapper_dispatch():
    """A CPU tensor takes the plain version for any label count; a device
    that is neither CPU nor CUDA raises."""
    from digipathai_tpu_torch.ops.bilateral import bilateral_message

    rng = np.random.default_rng(6)
    q = _t(rng.random((9, 11, 3)).astype(np.float32))
    img = _t(rng.integers(0, 255, (9, 11, 3)).astype(np.float32))
    n0 = bilateral_message.launches
    got = bilateral_message(q, img, 4.0, 20.0, 3)
    want = tcrf._bilateral_message(q, img, 4.0, 20.0, 3)
    assert torch.equal(got, want)
    assert bilateral_message.launches == n0  # no kernel on the CPU
    with pytest.raises(ValueError, match="device"):
        bilateral_message(q.to("meta"), img.to("meta"), 4.0, 20.0, 3)


def test_bilateral_cuda_tensor_without_kernel_raises(monkeypatch):
    """A CUDA tensor never takes the plain version: with no kernel to build
    the call raises.  Without a GPU, stand-in objects carry a CUDA device
    and the build is pointed at a missing nvcc."""
    import types

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel is available here")
    from digipathai_tpu_torch import _build
    from digipathai_tpu_torch.ops.bilateral import bilateral_message

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "missing.so")
    _build.load.cache_clear()
    calls = []
    monkeypatch.setattr(tcrf, "_bilateral_message",
                        lambda *a, **k: calls.append(1))
    cuda = torch.device("cuda", 0)
    q = types.SimpleNamespace(device=cuda, dtype=torch.float32,
                              shape=(4, 4, 2), dim=lambda: 3)
    img = types.SimpleNamespace(device=cuda, dtype=torch.float32,
                                shape=(4, 4, 3))
    before = bilateral_message.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcrf._bilateral_message_dispatch(q, img, 4.0, 20.0, 3)
    assert calls == [] and bilateral_message.launches == before
    _build.load.cache_clear()


@pytest.mark.parametrize("user_tf32", [True, False])
def test_no_tf32_guard_is_thread_safe(user_tf32, monkeypatch):
    """The blur's TF32 switch: off inside every guarded block, whichever
    thread is in it, and back to the user's setting once all have left.
    Stand-in objects carry a CUDA device, so this runs without a GPU."""
    import threading
    import time
    import types

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", user_tf32)
    x = types.SimpleNamespace(device=torch.device("cuda", 0))
    inside, errors = threading.Barrier(4, timeout=10), []

    def run():
        try:
            inside.wait()  # enter the guard together
            for _ in range(200):
                with tcrf._no_tf32(x):
                    time.sleep(0)  # a launch: another thread may run
                    assert torch.backends.cudnn.allow_tf32 is False
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert torch.backends.cudnn.allow_tf32 is user_tf32


@pytest.mark.parametrize("valid_hw", [None, (45, 58)])
def test_production_bilateral_message(valid_hw):
    rng = np.random.default_rng(7)
    h, w = 52, 64
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    q = rng.random((h, w, 2)).astype(np.float32)
    kw = dict(bil_sigma_xy=12.0, bil_sigma_rgb=20.0, bil_downsample=4,
              bil_radius=3)
    timg = _t(img)
    jimg = jnp.asarray(img)
    if valid_hw is not None:
        # as mean_field_crf feeds it: pad pixels carry the sentinel colour
        m = np.zeros((h, w, 1), bool)
        m[:valid_hw[0], :valid_hw[1]] = True
        img_f = np.where(m, img.astype(np.float32), jcrf._PAD_COLOR)
        q = q * m
        timg, jimg = _t(img_f), jnp.asarray(img_f)
    fn = jax.jit(functools.partial(jcrf.production_bilateral_message, **kw))
    want = np.asarray(fn(jnp.asarray(q), jimg, valid_hw=None if valid_hw is None
                         else jnp.asarray(valid_hw, jnp.int32)))
    got = tcrf.production_bilateral_message(_t(q), timg, valid_hw=valid_hw,
                                            **kw).numpy()
    assert got.shape == (h, w, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=MSG_BOUND)


@pytest.mark.parametrize("valid_hw", [None, (41, 50)])
def test_mean_field_crf(valid_hw):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    probs = rng.random((48, 64)).astype(np.float32)
    jv = None if valid_hw is None else jnp.asarray(valid_hw, jnp.int32)
    want = np.asarray(jcrf.mean_field_crf(jnp.asarray(img), jnp.asarray(probs),
                                          valid_hw=jv, **CRF_OPTS))
    got = tcrf.mean_field_crf(_t(img), _t(probs), valid_hw=valid_hw,
                              **CRF_OPTS).numpy()
    sl = (slice(None), slice(None)) if valid_hw is None else (
        slice(0, valid_hw[0]), slice(0, valid_hw[1]))
    np.testing.assert_allclose(got[sl], want[sl], rtol=0, atol=MF_BOUND)


@pytest.mark.parametrize("hw", [(97, 130), (2, 130)])
def test_refine_tile(hw):
    """A bucket-padded tile and a sliver tile (an extent below one
    downsample cell), against JAX's refine_tile."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
    probs = rng.random(hw).astype(np.float32)
    want = jcrf.refine_tile(img, probs, supertile=256, **CRF_OPTS)
    got = tcrf.refine_tile(img, probs, supertile=256, device="cpu", **CRF_OPTS)
    assert got.shape == hw and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=MF_BOUND)


def test_mean_field_from_unary_three_labels():
    """do_crf's multi-label iterations with the colour term, L = 3."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
    unary = rng.random((40, 48, 3)).astype(np.float32) * 2
    kw = dict(n_labels=3, n_iters=2, enable_color=True, pos_sigma=3.0,
              compat_gaussian=3.0, bil_sigma_xy=80.0, bil_sigma_rgb=13.0,
              bil_downsample=4, bil_radius=4, compat_bilateral=10.0)
    want = np.asarray(jcrf._mean_field_from_unary(
        jnp.asarray(img), jnp.asarray(unary), **kw))
    got = tcrf._mean_field_from_unary(_t(img), _t(unary), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MF_BOUND)


@pytest.mark.parametrize("enable_color,zero_unsure", [(True, False),
                                                      (False, True)])
def test_do_crf(enable_color, zero_unsure):
    """The label-input CRF end to end (radius 20, on a grid small enough
    that few shifts survive)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)
    labels = rng.choice(np.array([3, 7, 9], np.uint8), (16, 20))
    kw = dict(n_labels=3, enable_color=enable_color, zero_unsure=zero_unsure,
              n_iters=2)
    want = jcrf.do_crf(img, labels, **kw)
    got = tcrf.do_crf(img, labels, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {3, 7, 9}


# --------------------------------------------------------------- the engine

ENGINE_KW = dict(patch_size=128, stride_size=128, batch_size=4, quick=True,
                 model="oracle", mode="colon", supertile=384, num_workers=2,
                 save_float_probs=True, crf_opts=CRF_OPTS)


@pytest.fixture(scope="module")
def crf_slide(tmp_path_factory):
    from tests.fixtures import make_synthetic_slide

    p = tmp_path_factory.mktemp("crf") / "crf-slide.tiff"
    meta = make_synthetic_slide(str(p), 512, 512, seed=11)
    return str(p), meta


def _engine_run(engine, slide, out_dir, monkeypatch, **kw):
    """(mask, f32 probability map, status) of one run with its own cache."""
    from digipathai_tpu_torch.io.tiff_py import TiffReader

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(out_dir / "cache"))
    status = {}
    mask = np.asarray(engine(
        img_path=slide, probs_path=str(out_dir / "p.tiff"),
        mask_path=str(out_dir / "m.tiff"),
        uncertainty_path=str(out_dir / "u.tiff"), status=status,
        **{**ENGINE_KW, **kw}))
    with TiffReader(str(out_dir / "p.tiff.f32.tiff")) as r:
        probs = np.asarray(r.read_whole(0), np.float32).squeeze()
    return mask, probs, status


def _torch_engine(**kw):
    from digipathai_tpu_torch import getSegmentation

    return getSegmentation(device="cpu", **kw)


def test_engine_crf_matches_jax(crf_slide, tmp_path, monkeypatch):
    """Patch mode with crf=True: the f32 maps within 1e-4 of the JAX
    engine's, and the masks equal except within 1e-3 of the threshold."""
    from digipathai_tpu.engine.segmentation import getSegmentation as jax_seg

    path, _ = crf_slide
    got_mask, got, status = _engine_run(_torch_engine, path, tmp_path / "t",
                                        monkeypatch, crf=True)
    want_mask, want, _ = _engine_run(jax_seg, path, tmp_path / "j",
                                     monkeypatch, crf=True, data_parallel=False)
    raw_mask, raw, _ = _engine_run(_torch_engine, path, tmp_path / "raw",
                                   monkeypatch, crf=False)
    assert not np.array_equal(got, raw)  # the CRF changed the map
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    sure = np.abs(want.T - 0.3) > 1e-3
    np.testing.assert_array_equal(got_mask[sure], want_mask[sure])
    assert "crf" in status["timings"]


def test_engine_crf_lesion(crf_slide, tmp_path, monkeypatch):
    """The oracle's CRF-refined mask against the slide's lesion, the check
    of tests/test_crf.py::TestEngineCRFFlag."""
    from digipathai_tpu_torch.io.slide import Slide
    from digipathai_tpu_torch.utils.status import SegmentationStatus

    path, meta = crf_slide
    seen = []

    class Recording(SegmentationStatus):
        def __setitem__(self, k, v):
            if k == "status":
                seen.append(v)
            super().__setitem__(k, v)

    out = tmp_path / "o"
    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    _torch_engine(img_path=path, probs_path=str(out) + "-p.tiff",
                  mask_path=str(out) + "-m.tiff",
                  uncertainty_path=str(out) + "-u.tiff", crf=True,
                  status=Recording(), patch_size=128, stride_size=128,
                  batch_size=8, model="oracle", mode="colon", supertile=512,
                  num_workers=2)
    with Slide(str(out) + "-m.tiff") as sm:
        m = sm.read_level(0)[:, :, 0] > 127
    lesion = meta["lesion_mask"]
    jacc = ((m & lesion).sum() + 1) / ((m | lesion).sum() + 1)
    assert jacc > 0.6
    assert seen.index("Refining with CRF") == seen.index(
        "Running segmentation") + 1


def test_crf_knob_change_invalidates_state(crf_slide, tmp_path, monkeypatch):
    """cfg_key covers the crf knob (tests/test_resume.py:138): resuming with
    crf flipped reruns inference instead of reusing the raw maps."""
    path, _ = crf_slide
    calls = []
    _engine_run(_torch_engine, path, tmp_path, monkeypatch, crf=False)
    _engine_run(_torch_engine, path, tmp_path, monkeypatch, crf=True,
                resume=True, progress_cb=lambda d, t: calls.append(d))
    assert calls  # state invalidated -> inference actually reran


def test_staged_crf_tile_is_replayed(crf_slide, tmp_path, monkeypatch):
    """A crash right after a refined tile is staged: the resumed run replays
    the staged tile and refines the rest, giving the uninterrupted run's
    map."""
    from digipathai_tpu_torch.engine import segmentation as seg

    path, _ = crf_slide
    _, want, _ = _engine_run(_torch_engine, path, tmp_path / "clean",
                             monkeypatch, crf=True)
    real_replace = os.replace

    def crash_after_staging(src, dst):
        real_replace(src, dst)
        if "-crftile-" in str(dst):
            raise RuntimeError("crash after staging")

    monkeypatch.setattr(seg.os, "replace", crash_after_staging)
    with pytest.raises(RuntimeError, match="crash after staging"):
        _engine_run(_torch_engine, path, tmp_path / "crash", monkeypatch,
                    crf=True)
    monkeypatch.setattr(seg.os, "replace", real_replace)
    staged = list((tmp_path / "crash" / "cache" / "memmaps").glob(
        "*-crftile-*.npz"))
    assert len(staged) == 1
    calls = []
    _, got, _ = _engine_run(_torch_engine, path, tmp_path / "crash",
                            monkeypatch, crf=True, resume=True,
                            progress_cb=lambda d, t: calls.append(d))
    assert not calls  # inference was not rerun
    assert not staged[0].exists()
    np.testing.assert_array_equal(got, want)
