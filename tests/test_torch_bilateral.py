"""The Hopper bilateral-message kernel's host side and arithmetic, on the CPU.

``csrc/bilateral.cu`` runs only on the card.  These tests pin what it does
there with numpy: ``kernel_model`` is its arithmetic (the host-folded base-2
constants, colours staged times ``cs``, the exponent as three FMAs from the
spatial term, ``ex2`` flushing below 2^-126, out-of-image cells staged with
colour +inf and q = 0, the self term at -inf), and ``emulate_kernel`` walks
its blocks, halo layout and register-blocked loops as the source does.  Both
are held to the port's plain ``_bilateral_message`` within the Pallas
kernel's bound, 2e-5 (tests/test_pallas.py), which
``test_torch_crf.py::test_bilateral_plain_matches_jax`` ties to JAX.  The
plan's tests hold ``plan_bilateral`` to the shared memory of the card and to
the tiles the source compiles.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from digipathai_tpu_torch.ops import bilateral as bil
from digipathai_tpu_torch.ops import crf as tcrf

torch.set_num_threads(2)

MSG_BOUND = 2e-5  # tests/test_pallas.py
F32 = np.float32
INF = F32(np.inf)
SRC = Path(bil.__file__).resolve().parent.parent / "csrc" / "bilateral.cu"


def fma(x, y, z):
    """f32 fused multiply-add: the f64 product of two f32 values is exact,
    and the sum rounds once (to f64, then f32: off by at most an ulp)."""
    return (np.float64(x) * np.float64(y) + np.float64(z)).astype(F32)


def ex2(e):
    """ex2.approx.ftz.f32: 2^e, flushed to +0 below the smallest normal."""
    with np.errstate(under="ignore"):
        y = np.exp2(e.astype(np.float64)).astype(F32)
    return np.where(y < np.finfo(F32).tiny, F32(0.0), y)


def plain(q, img, sxy, srgb, r):
    return tcrf._bilateral_message(torch.from_numpy(q), torch.from_numpy(img),
                                   sxy, srgb, r).numpy()


def kernel_model(q, img, sxy, srgb, r):
    """The kernel's arithmetic, shift by shift over the whole grid."""
    a, cs = (F32(v) for v in bil.kernel_constants(sxy, srgb))
    h, w, n_labels = q.shape
    col = np.full((h + 2 * r, w + 2 * r, 3), INF, F32)
    col[r:r + h, r:r + w] = img * cs
    qs = np.zeros((h + 2 * r, w + 2 * r, n_labels), F32)
    qs[r:r + h, r:r + w] = q
    centre = col[r:r + h, r:r + w]
    den = np.zeros((h, w), F32)
    num = np.zeros((h, w, n_labels), F32)
    for dx in range(-r, r + 1):
        sx = F32(-a * F32(dx * dx))
        for dy in range(-r, r + 1):
            t = -INF if dy == dx == 0 else fma(-(dy * dy), a, sx)
            nb = col[r + dy:r + dy + h, r + dx:r + dx + w]
            d = centre - nb
            e = fma(-d[..., 0], d[..., 0], np.full((h, w), t, F32))
            e = fma(-d[..., 1], d[..., 1], e)
            e = fma(-d[..., 2], d[..., 2], e)
            wgt = ex2(e)
            den = den + wgt
            num = fma(wgt[..., None],
                      qs[r + dy:r + dy + h, r + dx:r + dx + w], num)
    return num / np.maximum(den, F32(1e-12))[..., None]


def emulate_kernel(q, img, sxy, srgb, r, plan):
    """The kernel as the source writes it: per block, the halo staged into
    one flat float4 array and NL - 1 flat planes; per warp row and lane, K
    outputs accumulated over the column walk (lanes vectorised)."""
    a, cs = (F32(v) for v in bil.kernel_constants(sxy, srgb))
    h, w, n_labels = q.shape
    k_rows, th, tw = plan.k, plan.th, bil.TW
    hw = tw + 2 * r
    cells = hw * (th + 2 * r)
    out = np.zeros_like(q)
    lanes = np.arange(tw)
    for by in range(-(-h // th)):
        for bx in range(-(-w // tw)):
            by0, bx0 = by * th, bx * tw
            i = np.arange(cells)
            gy, gx = by0 - r + i // hw, bx0 - r + i % hw
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            s_c = np.zeros((cells, 4), F32)
            s_c[:, :3] = INF
            s_q = np.zeros((n_labels - 1) * cells, F32)
            p = gy[inside] * w + gx[inside]
            s_c[inside, :3] = img.reshape(-1, 3)[p] * cs
            s_c[inside, 3] = q.reshape(-1, n_labels)[p, 0]
            for l in range(1, n_labels):
                s_q[(l - 1) * cells + i[inside]] = q.reshape(-1, n_labels)[p, l]
            for ty in range(plan.warps):
                row0 = ty * k_rows
                c = [s_c[(row0 + k + r) * hw + lanes + r, :3]
                     for k in range(k_rows)]
                den = [np.zeros(tw, F32) for _ in range(k_rows)]
                num = [np.zeros((tw, n_labels), F32) for _ in range(k_rows)]
                for dx in range(-r, r + 1):
                    sx = F32(-a * F32(dx * dx))
                    base = row0 * hw + lanes + r + dx
                    for j in range(k_rows + 2 * r):
                        cell = base + j * hw
                        nb = s_c[cell]
                        nq = np.stack([nb[:, 3]] + [
                            s_q[(l - 1) * cells + cell]
                            for l in range(1, n_labels)], -1)
                        for k in range(k_rows):
                            dy = j - k - r
                            if dy < -r or dy > r:
                                continue
                            t = (-INF if dy == dx == 0
                                 else fma(-(dy * dy), a, sx))
                            # a lane past the image's edge has an
                            # infinite centre (inf - inf): never stored
                            with np.errstate(invalid="ignore"):
                                d = c[k] - nb[:, :3]
                            e = fma(-d[:, 0], d[:, 0], np.full(tw, t, F32))
                            e = fma(-d[:, 1], d[:, 1], e)
                            e = fma(-d[:, 2], d[:, 2], e)
                            wgt = ex2(e)
                            den[k] = den[k] + wgt
                            num[k] = fma(wgt[:, None], nq, num[k])
                x = bx0 + lanes
                for k in range(k_rows):
                    y = by0 + row0 + k
                    ok = (x < w) & (y < h)
                    if y < h and ok.any():
                        out[y, x[ok]] = (num[k][ok] / np.maximum(
                            den[k][ok], F32(1e-12))[:, None])
    return out


def _sentinel_case(rng):
    """A bucket-padded grid (test_torch_crf.py's): pad cells carry
    _PAD_COLOR and a cell-mean dilution of it, and zero q."""
    h, w = 40, 56
    img = rng.integers(0, 255, (h, w, 3)).astype(F32)
    q = rng.random((h, w, 2)).astype(F32)
    img[30:] = tcrf._PAD_COLOR
    img[:, 44:] = tcrf._PAD_COLOR
    img[29, :44] = tcrf._PAD_COLOR / 64
    q[30:] = 0.0
    q[:, 44:] = 0.0
    return q, img, 5


def _case(name):
    """(q, img, sigma_xy, sigma_rgb, r) of a named seeded grid."""
    rng = np.random.default_rng(21)
    if name == "sentinel":
        q, img, r = _sentinel_case(rng)
        return q, img, 5.0, 20.0, r
    h, w, n_labels, r, sxy, srgb = {
        "labels3_r5": (37, 45, 3, 5, 4.0, 13.0),
        "below_window": (5, 7, 2, 10, 12.5, 20.0),
        "r10": (40, 70, 2, 10, 12.5, 20.0),
        "labels5_r2": (19, 40, 5, 2, 3.0, 20.0),
    }[name]
    img = (rng.random((h, w, 3)) * 255).astype(F32)
    q = rng.random((h, w, n_labels)).astype(F32)
    return q, img, sxy, srgb, r


@pytest.mark.parametrize("name", ["sentinel", "labels3_r5", "below_window",
                                  "r10"])
def test_kernel_model_matches_plain(name):
    """The kernel's arithmetic against the plain message: finite, within
    2e-5; on the sentinel grid the valid pixels see no pad neighbour."""
    q, img, sxy, srgb, r = _case(name)
    got = kernel_model(q, img, sxy, srgb, r)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, plain(q, img, sxy, srgb, r), rtol=0,
                               atol=MSG_BOUND)
    if name == "sentinel":
        crop = plain(q[:29, :44], img[:29, :44], sxy, srgb, r)
        np.testing.assert_allclose(got[:29, :44], crop, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,hw,k", [
    ("sentinel", None, 2), ("labels3_r5", (30, 45), 1),
    ("below_window", None, 2), ("labels5_r2", None, 4)])
def test_emulated_kernel_matches_model(name, hw, k):
    """The source's block walk (halo staging, register-blocked rows, the
    column walk's row offsets and the self term) gives the arithmetic
    model's message, at K = 1, 2 and 4 and ragged edges; label chunks of
    four and one as the wrapper launches them."""
    q, img, sxy, srgb, r = _case(name)
    if hw is not None:
        q, img = q[:hw[0], :hw[1]], img[:hw[0], :hw[1]]
    want = kernel_model(q, img, sxy, srgb, r)
    chunks = []
    for l0 in range(0, q.shape[-1], bil.MAX_LABELS):
        qc = np.ascontiguousarray(q[..., l0:l0 + bil.MAX_LABELS])
        plan = bil.plan_bilateral(*q.shape[:2], qc.shape[-1], r)._replace(
            k=k)
        chunks.append(emulate_kernel(qc, img, sxy, srgb, r, plan))
    got = np.concatenate(chunks, -1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_kernel_constants():
    """a and cs are the f32 base-2 constants; cs stays above 0 however
    large sigma_rgb is, so +inf colours still give weight 0."""
    a, cs = bil.kernel_constants(12.5, 20.0)
    assert a == F32(np.log2(np.e) / (2 * 12.5 ** 2))
    assert cs == F32(np.sqrt(np.log2(np.e) / (2 * 20.0 ** 2)))
    assert bil.kernel_constants(1.0, 1e300)[1] > 0
    assert F32(bil.kernel_constants(1.0, np.inf)[1]) * INF == INF


@pytest.mark.parametrize("n_labels", [1, 2, 3, 4])
@pytest.mark.parametrize("r", [0, 1, 3, 5, 10, 12, 20])
def test_plan_two_blocks_per_sm(r, n_labels):
    """For r <= 20 and L <= 4 two blocks fit an SM, at the engine's grids
    and at small ones; the tile is a compiled one, unrolled only where the
    source compiles that radius."""
    for h, w in ((1024, 1024), (1024, 512), (256, 256), (5, 7), (1, 300),
                 (300, 1)):
        plan = bil.plan_bilateral(h, w, n_labels, r)
        assert plan.smem <= bil.SMEM_TWO_BLOCKS
        assert 2 * bil.TW * plan.warps <= 2048  # threads on one SM
        assert (plan.k, plan.warps) in bil.TILES
        unrolled = (plan.k, plan.warps) in bil.SPECIALISED.get(r, ())
        assert plan.spec == (r if unrolled else 0)
        assert plan.smem == bil.halo_bytes(plan.th, n_labels, r)
        assert plan.blocks == -(-w // bil.TW) * -(-h // plan.th)


def test_plan_engine_grids():
    """The CRF's grids fill the card with K = 4 at the unrolled r = 10;
    do_crf's 256^2 grid at r = 20 takes K = 2, unrolled."""
    for h, w in ((1024, 1024), (1024, 512), (512, 1024)):
        plan = bil.plan_bilateral(h, w, 2, 10)
        assert (plan.k, plan.spec) == (4, 10) and plan.blocks >= bil.SMS
    plan = bil.plan_bilateral(256, 256, 3, 20)
    assert (plan.k, plan.spec) == (2, 20)


@pytest.mark.parametrize("n_labels,r_max", [(1, 50), (2, 44), (3, 39),
                                            (4, 35)])
def test_plan_limits(n_labels, r_max):
    """Shared memory never exceeds one block's 232,448 bytes; the largest
    radius a block's halo takes is planned, one beyond it raises, and
    every radius the one-thread-per-pixel kernel took (a 32 x 8 tile of
    (4 + L) planes) is planned."""
    for r in range(r_max + 1):
        plan = bil.plan_bilateral(64, 64, n_labels, r)
        assert plan.smem <= bil.SMEM_ONE_BLOCK
    old_max = max(r for r in range(100) if 4 * (32 + 2 * r) * (8 + 2 * r)
                  * (4 + n_labels) <= 227 * 1024)
    assert old_max <= r_max
    with pytest.raises(ValueError, match="halo"):
        bil.plan_bilateral(64, 64, n_labels, r_max + 1)
    with pytest.raises(ValueError):
        bil.plan_bilateral(64, 64, n_labels, -1)


def test_plan_mirrors_source():
    """The tiles and unrolled radii the plan may choose are the ones
    csrc/bilateral.cu instantiates."""
    src = SRC.read_text()
    ks = {int(k) for k in re.findall(r"case (\d+): return by_radius<NL, \1>",
                                     src)}
    assert ks == {k for k, _ in bil.TILES}
    assert {w for _, w in bil.TILES} == {
        int(w) for w in re.findall(r"if \(warps != (\d+)", src)}
    spec = {int(r) for r in re.findall(
        r"if \(spec == ([1-9]\d*)\) return launch<NL, K, 8, \1>", src)}
    assert spec == set(bil.SPECIALISED)
    assert all(k >= 2 for tiles in bil.SPECIALISED.values()
               for k, _ in tiles)
    assert "if constexpr (K >= 2)" in src
