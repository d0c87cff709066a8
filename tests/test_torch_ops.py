"""The port's plain ops (digipathai_tpu_torch/ops, engine/planner) against
the JAX functions they port, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


def _u8_image(seed, shape=(96, 80, 3)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[20:60, 10:50] = (rng.normal(180, 20, (40, 40, 3))
                         .clip(0, 255).astype(np.uint8))
    return img


@pytest.mark.parametrize("dtype", ["uint8", "float32", "ties"])
def test_otsu_threshold(dtype):
    from digipathai_tpu.ops.otsu import otsu_threshold as jx
    from digipathai_tpu_torch.ops.otsu import otsu_threshold as tx

    rng = np.random.default_rng(3)
    if dtype == "uint8":
        x = _u8_image(0)[..., 1]
    elif dtype == "float32":
        x = np.concatenate([rng.normal(0.2, 0.05, 500),
                            rng.normal(0.7, 0.1, 300)]).astype(np.float32)
    else:  # symmetric two-value data: several bins tie for the maximum
        x = np.array([0.0] * 10 + [1.0] * 10, np.float32)
    want = float(jx(jnp.asarray(x)))
    got = float(tx(torch.from_numpy(x)))
    assert got == want


def test_hsv_saturation_and_normalize():
    from digipathai_tpu.ops.color import normalize_patches as jn
    from digipathai_tpu.ops.color import rgb_to_hsv_saturation as js
    from digipathai_tpu_torch.ops.color import normalize_patches as tn
    from digipathai_tpu_torch.ops.color import rgb_to_hsv_saturation as ts

    img = _u8_image(1)
    img[0, 0] = 0  # max == 0 branch
    np.testing.assert_array_equal(ts(torch.from_numpy(img)).numpy(),
                                  np.asarray(js(jnp.asarray(img))))
    f = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(ts(torch.from_numpy(f)).numpy(),
                               np.asarray(js(jnp.asarray(f))), rtol=0,
                               atol=2e-7)
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tn(torch.from_numpy(img), dtype=td).float().numpy()
        want = np.asarray(jn(jnp.asarray(img), dtype=jd).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 5, 20])
def test_morphology_even_and_odd_kernels(k):
    from digipathai_tpu.ops import morphology as jm
    from digipathai_tpu_torch.ops import morphology as tm

    rng = np.random.default_rng(k)
    m = rng.random((45, 37)) > 0.7
    for name in ("dilate", "erode", "close", "open_"):
        got = getattr(tm, name)(torch.from_numpy(m), k).numpy()
        want = np.asarray(getattr(jm, name)(jnp.asarray(m), k))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} k={k}")


@pytest.mark.parametrize("level", [2, 3, 4])
def test_plan_mask(level):
    from digipathai_tpu.ops.morphology import plan_mask as jp
    from digipathai_tpu_torch.ops.morphology import plan_mask as tp

    from tests.fixtures import render_he_like

    img, _, _ = render_he_like(160, 120, seed=level)
    xyc = np.ascontiguousarray(img.transpose(1, 0, 2))
    got = tp(torch.from_numpy(xyc), level).numpy()
    want = np.asarray(jp(jnp.asarray(xyc), level))
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


def test_tissue_mask_patch():
    from digipathai_tpu.ops.morphology import tissue_mask_patch as jt
    from digipathai_tpu_torch.ops.morphology import tissue_mask_patch as tt

    img = np.random.default_rng(4).integers(200, 256, (2, 16, 16, 3))
    img = img.astype(np.uint8)
    np.testing.assert_array_equal(tt(torch.from_numpy(img)).numpy(),
                                  np.asarray(jt(jnp.asarray(img))))


@pytest.mark.parametrize("tta", ["DEFAULT", "FLIP_LEFT_RIGHT", "ROTATE_90",
                                 "ROTATE_180", "ROTATE_270"])
def test_tta_apply_and_invert(tta):
    from digipathai_tpu.ops import tta as jt
    from digipathai_tpu_torch.ops import tta as tt

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    p = rng.normal(size=(2, 6, 6)).astype(np.float32)
    fwd = tt.apply(torch.from_numpy(x), tta).numpy()
    np.testing.assert_array_equal(fwd, np.asarray(jt.apply(jnp.asarray(x), tta)))
    inv = tt.invert(torch.from_numpy(p), tta).numpy()
    np.testing.assert_array_equal(inv, np.asarray(jt.invert(jnp.asarray(p), tta)))
    # invert undoes apply
    np.testing.assert_array_equal(
        tt.invert(tt.apply(torch.from_numpy(x), tta), tta).numpy(), x)


def test_tta_lists_and_chains():
    from digipathai_tpu.ops import tta as jt
    from digipathai_tpu_torch.ops import tta as tt

    for lst in (None, ["hflip", "rot90"], ["DEFAULT", "ROTATE_270"]):
        assert tt.resolve_tta_list(lst) == jt.resolve_tta_list(lst)
    full = tt.resolve_tta_list(["hflip", "rot90", "rot180"])
    for faithful in (False, True):
        assert (tt.effective_transforms(full, faithful)
                == jt.effective_transforms(full, faithful))
    with pytest.raises(ValueError, match="unknown TTA"):
        tt.resolve_tta_list(["vflip"])
    x = np.arange(2 * 4 * 4).reshape(2, 4, 4, 1).astype(np.float32)
    chain = ["FLIP_LEFT_RIGHT", "ROTATE_90"]
    np.testing.assert_array_equal(
        tt.apply_chain(torch.from_numpy(x), chain).numpy(),
        np.asarray(jt.apply_chain(jnp.asarray(x), chain)))


@pytest.mark.parametrize("planes", [2, 3])
def test_stitch_batch(planes):
    from digipathai_tpu.ops.stitch import stitch_batch as js
    from digipathai_tpu_torch.ops.stitch import make_accumulator, stitch_batch

    rng = np.random.default_rng(planes)
    P, S, B = 8, 16, 5
    mean = rng.random((B, P, P)).astype(np.float32)
    var = rng.random((B, P, P)).astype(np.float32)
    offs = rng.integers(0, S, (B, 2)).astype(np.int32)
    offs[1] = offs[0]  # overlapping patches add up
    valid = np.array([True, True, False, True, True])
    acc = make_accumulator(S, P, planes=planes, device="cpu")
    got = stitch_batch(acc, torch.from_numpy(mean), torch.from_numpy(var),
                       offs, valid, patch=P)
    assert got is acc  # in place
    want = js(jnp.zeros((planes, S + P, S + P), jnp.float32), jnp.asarray(mean),
              jnp.asarray(var), jnp.asarray(offs), jnp.asarray(valid), patch=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)


def test_add_counts_host_matches_jax():
    from digipathai_tpu.ops.stitch import add_counts_host as ja
    from digipathai_tpu_torch.ops.stitch import add_counts_host as ta

    rng = np.random.default_rng(7)
    coords = rng.integers(0, 60, (40, 2)).astype(np.int32)
    valid = rng.random(40) > 0.2
    want = np.zeros((70, 65), np.float32)
    got = np.zeros((70, 65), np.float32)
    ja(want, coords, valid, 16)
    ta(got, coords, valid, 16)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1


def test_plan_patches_identical(synthetic_slide):
    from digipathai_tpu.engine.planner import plan_patches as jp
    from digipathai_tpu.io.slide import Slide
    from digipathai_tpu_torch.engine.planner import plan_patches as tp

    path, _ = synthetic_slide
    with Slide(path) as s:
        want = jp(s, patch=128, stride=64, batch=8, supertile=512)
        got = tp(s, patch=128, stride=64, batch=8, supertile=512)
    assert got.total_patches == want.total_patches > 0
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        assert g.origin == w.origin
        np.testing.assert_array_equal(g.coords, w.coords)
        np.testing.assert_array_equal(g.valid, w.valid)
    np.testing.assert_array_equal(got.tissue_mask, want.tissue_mask)
    np.testing.assert_array_equal(got.strided_mask, want.strided_mask)
    assert got.resolution == want.resolution


def test_finalize_maps():
    from digipathai_tpu.ops.stitch import finalize_maps as jf
    from digipathai_tpu_torch.ops.stitch import finalize_maps as tf

    rng = np.random.default_rng(8)
    mean, var = rng.random((2, 9, 7)).astype(np.float32)
    count = rng.integers(0, 4, (9, 7)).astype(np.float32)  # zeros -> 1
    got = tf(*(torch.from_numpy(a) for a in (mean, var, count)))
    want = jf(*(jnp.asarray(a) for a in (mean, var, count)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kernels", [(50, 35), (20, 5)])
def test_bin_morpho_process_mask(kernels):
    """The reference's close -> open cleanup, both of its kernel pairs."""
    from digipathai_tpu.ops.morphology import bin_morpho_process_mask as jb
    from digipathai_tpu_torch.ops.morphology import (
        bin_morpho_process_mask as tb)

    m = np.random.default_rng(7).random((128, 160)) > 0.7
    ck, ok = kernels
    got = tb(torch.from_numpy(m), close_k=ck, open_k=ok).numpy()
    want = np.asarray(jb(jnp.asarray(m), close_k=ck, open_k=ok))
    assert got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["tissue_mask_saturation_binary",
                                  "tissue_mask_saturation_otsu"])
def test_saturation_tissue_masks(name):
    from digipathai_tpu.ops import morphology as jm
    from digipathai_tpu_torch.ops import morphology as tm

    img = _u8_image(8)
    img[:10, :10] = 128  # grey: saturation 0
    got = getattr(tm, name)(torch.from_numpy(img)).numpy()
    want = np.asarray(getattr(jm, name)(jnp.asarray(img)))
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", ["float", "int", "constant"])
def test_normalize_minmax(data):
    from digipathai_tpu.ops.color import normalize_minmax as jn
    from digipathai_tpu_torch.ops.color import normalize_minmax as tn

    x = {"float": np.random.default_rng(5).normal(3, 2, (6, 5)),
         "int": np.arange(12).reshape(3, 4),
         "constant": np.full((3, 3), 7)}[data]
    got, want = tn(x), jn(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_get_mean_img():
    from digipathai_tpu.ops.stitch import get_mean_img as jg
    from digipathai_tpu_torch.ops.stitch import get_mean_img as tg

    rng = np.random.default_rng(6)
    maps = [rng.random((9, 7)) * 3 for _ in range(3)]
    count = rng.integers(0, 4, (9, 7)).astype(np.float32)  # zeros -> 1
    for g, w in zip(tg(maps, count), jg(maps, count)):
        np.testing.assert_array_equal(g, w)
