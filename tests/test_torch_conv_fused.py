"""The port's fused_conv3x3 (plain path on the CPU) against the JAX Pallas
kernel in interpret mode, at the shapes of tests/test_conv_fused.py.

The CUDA kernel itself has no interpret mode; chip_smoke.py compares it with
the plain version on the card.  Here the wrapper's CPU dispatch and its
refusal to fall back for a CUDA tensor are checked.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

TOL = 2e-4  # the bound of tests/test_conv_fused.py


def _inputs(n, h, w, c, f, seed, pre):
    rng = np.random.default_rng(seed)
    d = {"x": rng.normal(0, 1, (n, h, w, c)).astype(np.float32),
         "k": rng.normal(0, 0.2, (3, 3, c, f)).astype(np.float32)}
    if pre:
        d["pre_mul"] = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
        # strictly positive offsets: the border-leak case
        d["pre_add"] = rng.uniform(0.1, 0.5, (c,)).astype(np.float32)
    else:
        d["bias"] = rng.normal(0, 0.1, (f,)).astype(np.float32)
        d["mul"] = rng.uniform(0.5, 1.5, (f,)).astype(np.float32)
        d["add"] = rng.normal(0, 0.1, (f,)).astype(np.float32)
    return d


def _jax(d, relu, **kw):
    """JAX kernel, one N=1 call per image (it asserts N == 1)."""
    from digipathai_tpu.ops.pallas.conv_fused import fused_conv3x3

    args = {k: jnp.asarray(v) for k, v in d.items() if k not in ("x", "k")}
    outs = [np.asarray(fused_conv3x3(jnp.asarray(d["x"][i:i + 1]),
                                     jnp.asarray(d["k"]), relu=relu,
                                     interpret=True, **args, **kw))
            for i in range(d["x"].shape[0])]
    return np.concatenate(outs)


def _torch(d, relu):
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return fused_conv3x3(t.pop("x"), t.pop("k"), relu=relu, **t).numpy()


@pytest.mark.parametrize("n,h,w,c,f,pre,relu", [
    (1, 12, 24, 5, 7, False, True),
    (1, 8, 512, 64, 64, False, True),
    (1, 12, 24, 5, 7, True, False),
    (1, 40, 300, 128, 32, True, False),
    (3, 12, 24, 5, 7, True, True),      # N=3 against three N=1 calls
    (3, 9, 17, 16, 24, False, False),
])
def test_matches_pallas_kernel(n, h, w, c, f, pre, relu):
    d = _inputs(n, h, w, c, f, seed=h + c + f, pre=pre)
    want = _jax(d, relu, block_rows=4, block_cols=128)
    got = _torch(d, relu)
    assert got.shape == (n, h, w, f)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_no_affine_no_relu():
    rng = np.random.default_rng(0)
    d = {"x": rng.normal(0, 1, (1, 8, 16, 3)).astype(np.float32),
         "k": rng.normal(0, 0.3, (3, 3, 3, 4)).astype(np.float32)}
    want = _jax(d, False, block_rows=4, block_cols=16)
    np.testing.assert_allclose(_torch(d, False), want, rtol=TOL, atol=TOL)


def test_bf16_pre_activation_rounds_like_jax():
    """bf16: x * pre_mul and + pre_add each round to bf16 on both sides."""
    d = _inputs(1, 8, 16, 16, 8, seed=9, pre=True)
    xb = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    from digipathai_tpu.ops.pallas.conv_fused import fused_conv3x3 as jf
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3 as tf

    want = np.asarray(jf(xb, jnp.asarray(d["k"]), relu=False,
                         pre_mul=jnp.asarray(d["pre_mul"]),
                         pre_add=jnp.asarray(d["pre_add"]),
                         block_rows=4, block_cols=16,
                         interpret=True).astype(jnp.float32))
    got = tf(torch.from_numpy(d["x"]).bfloat16(), torch.from_numpy(d["k"]),
             relu=False, pre_mul=torch.from_numpy(d["pre_mul"]),
             pre_add=torch.from_numpy(d["pre_add"])).float().numpy()
    # one bf16 rounding of the output (2^-8 relative) apart at most, plus
    # the f32 summation order
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_cuda_tensor_without_kernel_raises(monkeypatch):
    """A CUDA tensor never takes the plain path: with no kernel available
    the call raises.  Without a GPU, a stand-in object carries a CUDA device
    and the build is pointed at a missing nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the kernel is available here")
    from digipathai_tpu_torch import _build
    from digipathai_tpu_torch.ops import conv_fused

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "missing.so")
    _build.load.cache_clear()
    calls = []
    monkeypatch.setattr(conv_fused, "fused_conv3x3_plain",
                        lambda *a, **k: calls.append(1))
    fake = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dtype=torch.bfloat16, shape=(1, 4, 4, 8),
                                 dim=lambda: 4, is_contiguous=lambda: True)
    before = conv_fused.fused_conv3x3.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        conv_fused.fused_conv3x3(fake, torch.zeros(3, 3, 8, 8))
    assert calls == [] and conv_fused.fused_conv3x3.launches == before
    _build.load.cache_clear()


def test_other_devices_raise():
    from digipathai_tpu_torch.ops.conv_fused import fused_conv3x3

    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv3x3(x, torch.zeros(3, 3, 8, 8))


# ------------------------------------------------- the kernel's host side

def _main_path_convs():
    """(n, h, w, c0, c1, f, taps) of every distinct conv the main paths
    launch: a batch-32 256^2 forward and a 4352^2 tile forward with its
    five decoder stages fused (convA at taps 2 over y, convB at taps 3), of
    the DenseNet and of the Inception U-Net (whose decoder adds
    (32,16,16,1536)->320, (32,16,16,1408)->320, (32,32,32,576)->256 and
    (32,64,64,320)->128, and three stage shapes)."""
    from digipathai_tpu_torch.models import densenet_unet, inception_unet

    calls = []
    for model in (densenet_unet, inception_unet):
        calls += model.kernel_calls(32, 256) + model.kernel_calls(1, 4352, 5)
    out = []
    for kind, shape in dict.fromkeys((k, s) for k, s, _ in calls):
        if kind == "conv":
            n, h, w, c, f, _ = shape
            out.append((n, h, w, c, 0, f, 3))
        else:
            n, hh, wh, c, cs, f = shape
            out += [(n, hh, wh, c, 0, f, 2), (n, 2 * hh, 2 * wh, f, cs, f, 3)]
    return out


@pytest.mark.parametrize("shape", _main_path_convs())
def test_plan_covers_m_f_and_k_once(shape):
    """Every output pixel, channel and K chunk of a main-path conv is
    computed by exactly one (tile, N tile, parity) and one split."""
    from digipathai_tpu_torch.ops.conv_fused import (SMEM_ONE_BLOCK,
                                                     plan_conv, stage_bytes)

    n, hi, wi, c0, c1, f, taps = shape
    plan = plan_conv(n, hi, wi, c0, c1, f, torch.bfloat16, taps=taps)
    assert plan.vector
    th, tw, bn = plan.th, plan.tw, plan.bn
    ty, tx, nt = -(-hi // th), -(-wi // tw), -(-f // bn)
    parities = 4 if taps == 2 else 1
    assert plan.tiles == n * ty * tx * nt * parities
    # rows and columns: the tiles partition [0, hi) x [0, wi) per image
    rows = np.zeros(hi, int)
    for t in range(ty):
        rows[t * th:min(hi, (t + 1) * th)] += 1
    cols = np.zeros(wi, int)
    for t in range(tx):
        cols[t * tw:min(wi, (t + 1) * tw)] += 1
    assert (rows == 1).all() and (cols == 1).all()
    # output pixels: taps 2 writes (2i + a, 2j + b), one parity each
    if taps == 2:
        hit = np.zeros((2 * hi, 2 * wi), int)
        for a in (0, 1):
            for b in (0, 1):
                hit[a::2, b::2] += 1
        assert (hit == 1).all()
    chans = np.zeros(nt * bn, int)
    for t in range(nt):
        chans[t * bn:(t + 1) * bn] += 1
    assert (chans[:f] == 1).all()
    # K: the splits partition the chunks, and the chunks cover C
    ks = np.zeros(plan.chunks, int)
    for b, e in plan.k_ranges():
        assert b < e
        ks[b:e] += 1
    assert (ks == 1).all() and plan.splits == len(plan.k_ranges())
    assert (plan.chunks - 1) * plan.bk < c0 + c1 <= plan.chunks * plan.bk
    sb = stage_bytes(taps, plan.tile_m, tw, plan.bk, bn)
    assert plan.stages >= 3
    assert plan.stages * (sb + 8) + 8 * bn <= SMEM_ONE_BLOCK
    # fewer than two waves of tiles: K is split
    assert (plan.splits > 1) == (plan.tiles < 264)


def _emulate(plan, ops, x0, x1, relu, ho, wo):
    """The wgmma path of csrc/conv3x3_igemm.cuh in numpy: each block's
    window and kernel slab laid out in "shared memory" as the kernel lays
    them out, each wgmma read through its descriptor (start address, LBO,
    SBO, no swizzle), the f32 partials summed in split order, the epilogue
    rounded once to bf16."""
    taps, bn, bk, tw = ops.taps, plan.bn, plan.bk, plan.tw
    tm = plan.tile_m
    mi, th, kg = tm // 128, plan.th, bk // 8
    wr_, wc_ = th + taps - 1, tw + taps - 1
    x = x0 if x1 is None else torch.cat([x0, x1], -1)
    if ops.pm is not None:  # the pre-activation, applied to in-image pixels
        x = torch.relu(x * ops.pm + ops.pa)
    x = x.float().numpy()
    n, hi, wi, c = x.shape
    f, nc, nt = ops.f, plan.chunks, -(-ops.f // bn)
    w = ops.w.float().numpy().reshape(-1)
    slab = taps * taps * bk * bn
    out = np.zeros((n, ho, wo, f), np.float32)
    # element offsets of a 64 x 16 A and a 16 x bn B inside their windows
    m, kk = np.arange(64)[:, None], np.arange(16)[None, :]
    lbo_a, sbo_a = wc_ * 8, kg * wc_ * 8
    a_idx = (m // 8) * sbo_a + (m % 8) * 8 + (kk // 8) * lbo_a + kk % 8
    kb, nn = np.arange(16)[:, None], np.arange(bn)[None, :]
    b_idx = (nn // 8) * 64 + (nn % 8) * 8 + (kb // 8) * (bn * 8) + kb % 8
    for p in range(4 if taps == 2 else 1):
        a_, b_ = (p >> 1, p & 1) if taps == 2 else (0, 0)
        oy0, ox0, os_ = (a_ - 1, b_ - 1, 2) if taps == 2 else (-1, -1, 1)
        for img in range(n):
            for y0 in range(0, hi, th):
                for x0_ in range(0, wi, tw):
                    for t in range(nt):
                        acc = np.zeros((tm, bn), np.float64)
                        for cb, ce in plan.k_ranges():
                            part = np.zeros((tm, bn), np.float64)
                            for ch in range(cb, ce):
                                win = np.zeros((wr_, kg, wc_, 8), np.float32)
                                for r in range(wr_):
                                    for q in range(wc_):
                                        iy, ix = y0 + oy0 + r, x0_ + ox0 + q
                                        if 0 <= iy < hi and 0 <= ix < wi:
                                            v = x[img, iy, ix,
                                                  ch * bk:(ch + 1) * bk]
                                            v = np.pad(v, (0, bk - v.size))
                                            win[r, :, q] = v.reshape(kg, 8)
                                win = win.reshape(-1)
                                sb = w[((p * nt + t) * nc + ch) * slab:][:slab]
                                for wg in (0, 1):
                                    for i in range(mi):
                                        wr0 = 8 * i if tw == 16 else \
                                            8 * (wg * mi + i)
                                        wc0 = 8 * wg if tw == 16 else 0
                                        rows = slice((wg * mi + i) * 64,
                                                     (wg * mi + i + 1) * 64)
                                        for dy in range(taps):
                                            for dx in range(taps):
                                                for s in range(kg // 2):
                                                    sa = (((wr0 + dy) * kg
                                                           + 2 * s) * wc_
                                                          + wc0 + dx) * 8
                                                    sbb = ((dy * taps + dx)
                                                           * kg + 2 * s) \
                                                        * bn * 8
                                                    part[rows] += (
                                                        win[sa + a_idx]
                                                        @ sb[sbb + b_idx])
                            acc += part
                        for mm in range(tm):
                            blk, r, q = mm >> 6, (mm >> 3) & 7, mm & 7
                            wg, i = blk // mi, blk % mi
                            row = y0 + (8 * i if tw == 16 else 8 * blk) + r
                            col = x0_ + (8 * wg if tw == 16 else 0) + q
                            fs = slice(t * bn, min(f, (t + 1) * bn))
                            if row < hi and col < wi:
                                out[img, row * os_ + a_, col * os_ + b_,
                                    fs] = acc[mm, :fs.stop - fs.start]
    z = out * ops.mul.numpy() + ops.off.numpy()
    if relu:
        z = np.maximum(z, 0.0)
    return torch.from_numpy(z).bfloat16().float().numpy()


@pytest.mark.parametrize("case", [
    # (n, h, w, c, f, pre, taps): pre-activation and a split K; 8-column
    # tiles; the folded upsample classes; a 512-position tile (BN 64); a
    # 32-channel K chunk (BN 96)
    (2, 9, 20, 40, 24, True, 3),
    (1, 40, 8, 16, 32, False, 3),
    (1, 5, 7, 16, 16, False, 2),
    (1, 6, 9, 24, 64, False, 3),
    (1, 5, 11, 40, 96, False, 3),
])
def test_prepared_operands_match_raw(case):
    """``prepare`` lays the operands out as the kernel reads them: the
    kernel's addressing, run on the prepared operands in numpy, gives the
    plain version's output on the raw ones (bf16, within 2^-6 of scale:
    the plain version rounds the conv to bf16 before its affine)."""
    from digipathai_tpu_torch.ops.conv_fused import (fused_conv3x3_plain,
                                                     plan_conv, prepare)
    from digipathai_tpu_torch.ops.stage_fused import (conv_up_folded_plain,
                                                      fold_upsample_kernel)

    n, h, w, c, f, pre, taps = case
    d = _inputs(n, h, w, c, f, seed=h * w + c, pre=pre)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x, k = t.pop("x").bfloat16(), t.pop("k")
    plan = plan_conv(n, h, w, c, 0, f, torch.bfloat16, taps=taps)
    assert plan.vector
    if taps == 3:
        ops = prepare(k, **t, dtype=torch.bfloat16, device="cpu")
        want = fused_conv3x3_plain(x, k, **t, relu=not pre)
        got = _emulate(plan, ops, x, None, not pre, h, w)
    else:
        ops = prepare(fold_upsample_kernel(k), **t, dtype=torch.bfloat16,
                      device="cpu")
        want = conv_up_folded_plain(x, k, **t)
        got = _emulate(plan, ops, x, None, True, 2 * h, 2 * w)
    want = want.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2 ** -6 * max(1.0, np.abs(want).max()), err
