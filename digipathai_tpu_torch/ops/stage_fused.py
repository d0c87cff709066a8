"""One whole U-Net decoder stage: the Hopper kernel and its plain twin.

``fused_up_stage`` computes, on NHWC tensors,

    a   = relu((conv3x3_same(upsample2x(y), ka) + biasa) * mula + adda)
    out = relu((conv3x3_same(concat[a, skip], kb) + biasb) * mulb + addb)

with ``a`` rounded once to the activation type before the second conv, and
relu dropped from both when ``relu=False``.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/stage_fused.py``
(``fused_up_stage``, N=1 only) with ``csrc/stage_fused.cu``: two launches on
one stream of the implicit-GEMM conv that ``fused_conv3x3`` launches too
(``csrc/conv3x3_igemm.cuh``; bf16 on ``wgmma`` with f32 accumulation).

- convA runs on folded taps.  After a nearest 2x upsample, output pixel
  (2i + a, 2j + b) reads y rows i-1+a .. i+a and columns j-1+b .. j+b only,
  so ``fold_upsample_kernel`` sums ka into four 2x2 kernels, one per parity
  class (a, b): rows [k0, k1 + k2] for a = 0 and [k0 + k1, k2] for a = 1,
  columns likewise, in f32, rounded once to the activation type (the TPU
  kernel folds the rows the same way).  That is 4 taps per output pixel,
  not 9, and the upsampled tensor never exists; ``conv_up_folded_plain``
  is its plain version.
- convB reads its channels from ``a`` and ``skip`` by two base pointers, so
  the concat never exists; ``a`` makes one round trip through a scratch
  tensor.

The kernel takes any N >= 1, C, Cs and F.  ``prepare_stage`` lays out both
convs' operands once (``conv_fused.prepare``); the model hands them to the
wrapper in place of ``ka`` and ``kb``.

Dispatch: shapes and dtypes are checked first; then a CPU tensor runs
``fused_up_stage_plain`` (on the raw parameters of prepared operands) and a
CUDA tensor launches the kernel or raises.
``fused_up_stage.launches`` counts kernel launches, one per stage call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv_fused import (_DTYPES, ConvOperands, epilogue_plain,
                         fused_conv3x3_plain, plan_conv, prepare, scratch)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def fold_upsample_kernel(ka: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) -> (4, 2, 2, C, F) f32: the 2x2 kernel of each output
    parity class p = 2a + b of a 3x3 SAME conv over a nearest 2x upsample,
    indexed [p, row tap, column tap]; tap t of class a reads y row
    i - 1 + a + t."""
    k = ka.float()

    def fold(k, a, dim):
        k0, k1, k2 = k.unbind(dim)
        return torch.stack([k0, k1 + k2] if a == 0 else [k0 + k1, k2], dim)

    return torch.stack([fold(fold(k, a, 0), b, 1)
                        for a in (0, 1) for b in (0, 1)])


def conv_up_folded_plain(y, ka, bias=None, mul=None, add=None, *,
                         relu=True):
    """Plain PyTorch convA on folded taps, as the kernel computes it:
    ``conv3x3_same(upsample2x(y), ka)`` with the affine and relu, as four
    2x2 convs over y padded by one zero pixel, each written to its parity
    class.  (``fused_up_stage_plain`` upsamples and runs the 3x3 conv, the
    faster form for cuDNN.)"""
    n, hh, wh, _ = y.shape
    kf = fold_upsample_kernel(ka).to(y.device, y.dtype)
    yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1))
    z = y.new_empty(n, kf.shape[-1], 2 * hh, 2 * wh)
    for a in (0, 1):
        for b in (0, 1):
            z[:, :, a::2, b::2] = F.conv2d(
                yp[:, :, a:a + hh + 1, b:b + wh + 1],
                kf[2 * a + b].permute(3, 2, 0, 1))
    return epilogue_plain(z.permute(0, 2, 3, 1), kf.shape[-1], bias, mul,
                          add, relu)


def fused_up_stage_plain(y, ka, biasa, mula, adda, kb, biasb, mulb, addb,
                         skip=None, *, relu=True):
    """Plain PyTorch version: upsample, conv, concat, conv, each conv
    through ``fused_conv3x3_plain``, which rounds ``a`` to y.dtype.  ka and
    kb may be the ``ConvOperands`` of ``prepare_stage``, whose raw
    parameters it takes."""
    if isinstance(ka, ConvOperands):
        ka, biasa, mula, adda = ka.raw[:4]
        kb, biasb, mulb, addb = kb.raw[:4]
    a = fused_conv3x3_plain(upsample2x(y), ka, biasa, mula, adda, relu=relu)
    x = a if skip is None else torch.cat([a, skip.to(a.dtype)], dim=-1)
    return fused_conv3x3_plain(x, kb, biasb, mulb, addb, relu=relu)


def prepare_stage(ka, biasa, mula, adda, kb, biasb, mulb, addb, *, dtype,
                  device):
    """Both convs' operands for the kernel: convA's kernel folded, convB's
    reading F channels from ``a`` and the rest from ``skip``."""
    opa = prepare(fold_upsample_kernel(ka), biasa, mula, adda, dtype=dtype,
                  device=device)
    return (opa._replace(raw=(ka, biasa, mula, adda, None, None)),
            prepare(kb, biasb, mulb, addb, dtype=dtype, device=device,
                    c0=ka.shape[-1]))


def _check(y, ka, kb, skip, vectors):
    if y.dtype not in _DTYPES:
        raise TypeError(f"fused_up_stage: dtype {y.dtype} not in {_DTYPES}")
    if y.dim() != 4:
        raise ValueError(f"fused_up_stage: y must be NHWC, got shape "
                         f"{tuple(y.shape)}")
    n, hh, wh, c = y.shape
    cs = 0
    if skip is not None:
        if skip.dim() != 4 or tuple(skip.shape[:3]) != (n, 2 * hh, 2 * wh):
            raise ValueError(f"fused_up_stage: skip shape {tuple(skip.shape)}"
                             f" is not ({n}, {2 * hh}, {2 * wh}, Cs)")
        cs = skip.shape[-1]
    if isinstance(ka, ConvOperands):
        f = ka.f
        if ((ka.taps, ka.c, ka.dtype) != (2, c, y.dtype)
                or not isinstance(kb, ConvOperands)
                or (kb.taps, kb.c0, kb.c, kb.f) != (3, f, f + cs, f)
                or any(v is not None for v in vectors.values())):
            raise ValueError("fused_up_stage: prepared operands do not take "
                             f"y {tuple(y.shape)} {y.dtype} and Cs={cs}")
        return n, hh, wh, c, cs, f
    if ka.dim() != 4 or tuple(ka.shape[:3]) != (3, 3, c):
        raise ValueError(f"fused_up_stage: ka shape {tuple(ka.shape)} is not "
                         f"(3, 3, {c}, F)")
    f = ka.shape[-1]
    if tuple(kb.shape) != (3, 3, f + cs, f):
        raise ValueError(f"fused_up_stage: kb shape {tuple(kb.shape)} is not "
                         f"(3, 3, {f + cs}, {f})")
    for name, v in vectors.items():
        if v is not None and tuple(v.shape) != (f,):
            raise ValueError(f"fused_up_stage: {name} shape "
                             f"{tuple(v.shape)} != ({f},)")
    return n, hh, wh, c, cs, f


def stage_plans(n, hh, wh, c, cs, f, dtype):
    """(convA, convB) launch plans of one stage."""
    return (plan_conv(n, hh, wh, c, 0, f, dtype, taps=2),
            plan_conv(n, 2 * hh, 2 * wh, f, cs, f, dtype))


def launch(y, opa, opb, skip, *, relu, out, a, part=None, plans=None):
    """Launch both convs on CUDA operands that are in place: y contiguous,
    ``a`` and ``out`` (N, 2Hh, 2Wh, F), ``part`` the split-K scratch of
    ``plans`` (``stage_plans`` of this shape when None).  Counts the
    launch."""
    from .. import _build

    n, hh, wh, c = y.shape
    cs = 0 if skip is None else skip.shape[-1]
    f = opa.f
    pa_, pb_ = plans or stage_plans(n, hh, wh, c, cs, f, y.dtype)
    lib = _build.load("stage_fused")
    dev = y.device
    with torch.cuda.device(dev):
        rc = lib.dpai_fused_up_stage(
            y.data_ptr(), None if skip is None else skip.data_ptr(),
            opa.w.data_ptr(), opa.mul.data_ptr(), opa.off.data_ptr(),
            opb.w.data_ptr(), opb.mul.data_ptr(), opb.off.data_ptr(),
            a.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), n, hh, wh, c, cs, f,
            int(relu), int(y.dtype == torch.bfloat16), pa_.as_c(),
            pb_.as_c(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_up_stage: kernel launch failed with CUDA error {rc} "
            f"(N={n} Hh={hh} Wh={wh} C={c} Cs={cs} F={f})")
    _build.count_launch(fused_up_stage)
    return out


def fused_up_stage(y, ka, biasa, mula, adda, kb, biasb, mulb, addb,
                   skip=None, *, relu=True):
    """One decoder stage (see the module docstring).

    y: (N, Hh, Wh, C) float32 or bfloat16; ka: (3, 3, C, F); skip:
    (N, 2Hh, 2Wh, Cs) or None; kb: (3, 3, F + Cs, F); bias*/mul*/add*:
    (F,) or None.  ka and kb may instead be the two ``ConvOperands`` that
    ``prepare_stage`` made for y's device (then the vectors are None).
    Returns (N, 2Hh, 2Wh, F) in y.dtype.
    """
    n, hh, wh, c, cs, f = _check(y, ka, kb, skip, {
        "biasa": biasa, "mula": mula, "adda": adda,
        "biasb": biasb, "mulb": mulb, "addb": addb})
    prepared = isinstance(ka, ConvOperands)
    if prepared and not ka.w.device == kb.w.device == y.device:
        raise ValueError(f"fused_up_stage: operands prepared on {ka.w.device} "
                         f"do not take y on {y.device}")
    if y.device.type == "cpu":
        return fused_up_stage_plain(y, ka, biasa, mula, adda, kb, biasb, mulb,
                                    addb, skip, relu=relu)
    if y.device.type != "cuda":
        raise ValueError(f"fused_up_stage: unsupported device {y.device}")
    if skip is not None and skip.device != y.device:
        raise ValueError("fused_up_stage: y and skip on different devices")
    from .. import _build

    _build.load("stage_fused")  # raises before any work if it cannot build
    dev, dt = y.device, y.dtype
    out = torch.empty((n, 2 * hh, 2 * wh, f), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    a = torch.empty_like(out)  # convA's output, read back by convB
    y = y.contiguous()
    sk = None if skip is None else skip.to(dt).contiguous()
    opa, opb = (ka, kb) if prepared else prepare_stage(
        ka, biasa, mula, adda, kb, biasb, mulb, addb, dtype=dt, device=dev)
    plans = stage_plans(n, hh, wh, c, cs, f, dt)
    return launch(y, opa, opb, sk, relu=relu, out=out, a=a, plans=plans,
                  part=scratch(plans, n * 4 * hh * wh, f, dev))


fused_up_stage.launches = 0
