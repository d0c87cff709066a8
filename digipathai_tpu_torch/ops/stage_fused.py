"""One whole U-Net decoder stage: the Hopper kernel and its plain twin.

``fused_up_stage`` computes, on NHWC tensors,

    a   = relu((conv3x3_same(upsample2x(y), ka) + biasa) * mula + adda)
    out = relu((conv3x3_same(concat[a, skip], kb) + biasb) * mulb + addb)

with ``a`` rounded once to the activation type before the second conv, and
relu dropped from both when ``relu=False``.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/stage_fused.py``
(``fused_up_stage``, N=1 only) with ``csrc/stage_fused.cu``: two launches on
one stream of the implicit-GEMM conv that ``fused_conv3x3`` launches too
(``csrc/conv3x3_igemm.cuh``; tensor-core ``mma.sync`` in bf16 with f32
accumulation).  convA gathers its input through the upsample and convB
reads its channels from ``a`` and ``skip`` by two base pointers, so neither
the upsampled tensor nor the concat exists in device memory; ``a`` makes one
round trip through a scratch tensor.  The kernel takes any N >= 1, C, Cs
and F.

Dispatch: shapes and dtypes are checked first; then a CPU tensor runs
``fused_up_stage_plain`` and a CUDA tensor launches the kernel or raises.
``fused_up_stage.launches`` counts kernel launches, one per stage call.
"""

from __future__ import annotations

import torch

from .conv_fused import _DTYPES, _affine, fused_conv3x3_plain


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def fused_up_stage_plain(y, ka, biasa, mula, adda, kb, biasb, mulb, addb,
                         skip=None, *, relu=True):
    """Plain PyTorch version: upsample, conv, concat, conv, each conv
    through ``fused_conv3x3_plain``, which rounds ``a`` to y.dtype."""
    a = fused_conv3x3_plain(upsample2x(y), ka, biasa, mula, adda, relu=relu)
    x = a if skip is None else torch.cat([a, skip.to(a.dtype)], dim=-1)
    return fused_conv3x3_plain(x, kb, biasb, mulb, addb, relu=relu)


def _check(y, ka, kb, skip, vectors):
    if y.dtype not in _DTYPES:
        raise TypeError(f"fused_up_stage: dtype {y.dtype} not in {_DTYPES}")
    if y.dim() != 4:
        raise ValueError(f"fused_up_stage: y must be NHWC, got shape "
                         f"{tuple(y.shape)}")
    n, hh, wh, c = y.shape
    if ka.dim() != 4 or tuple(ka.shape[:3]) != (3, 3, c):
        raise ValueError(f"fused_up_stage: ka shape {tuple(ka.shape)} is not "
                         f"(3, 3, {c}, F)")
    f = ka.shape[-1]
    cs = 0
    if skip is not None:
        if skip.dim() != 4 or tuple(skip.shape[:3]) != (n, 2 * hh, 2 * wh):
            raise ValueError(f"fused_up_stage: skip shape {tuple(skip.shape)}"
                             f" is not ({n}, {2 * hh}, {2 * wh}, Cs)")
        cs = skip.shape[-1]
    if tuple(kb.shape) != (3, 3, f + cs, f):
        raise ValueError(f"fused_up_stage: kb shape {tuple(kb.shape)} is not "
                         f"(3, 3, {f + cs}, {f})")
    for name, v in vectors.items():
        if v is not None and tuple(v.shape) != (f,):
            raise ValueError(f"fused_up_stage: {name} shape "
                             f"{tuple(v.shape)} != ({f},)")
    return n, hh, wh, c, cs, f


def fused_up_stage(y, ka, biasa, mula, adda, kb, biasb, mulb, addb,
                   skip=None, *, relu=True):
    """One decoder stage (see the module docstring).

    y: (N, Hh, Wh, C) float32 or bfloat16; ka: (3, 3, C, F); skip:
    (N, 2Hh, 2Wh, Cs) or None; kb: (3, 3, F + Cs, F); bias*/mul*/add*:
    (F,) or None.  Returns (N, 2Hh, 2Wh, F) in y.dtype.
    """
    n, hh, wh, c, cs, f = _check(y, ka, kb, skip, {
        "biasa": biasa, "mula": mula, "adda": adda,
        "biasb": biasb, "mulb": mulb, "addb": addb})
    if y.device.type == "cpu":
        return fused_up_stage_plain(y, ka, biasa, mula, adda, kb, biasb, mulb,
                                    addb, skip, relu=relu)
    if y.device.type != "cuda":
        raise ValueError(f"fused_up_stage: unsupported device {y.device}")
    if skip is not None and skip.device != y.device:
        raise ValueError("fused_up_stage: y and skip on different devices")
    from .. import _build

    lib = _build.load("stage_fused")
    dev, dt = y.device, y.dtype
    out = torch.empty((n, 2 * hh, 2 * wh, f), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    a = torch.empty_like(out)  # convA's output, read back by convB
    y = y.contiguous()
    sk = None if skip is None else skip.to(dt).contiguous()
    wa = ka.to(dev, dt).contiguous()
    wb = kb.to(dev, dt).contiguous()
    mula_, offa = _affine(f, biasa, mula, adda, dev)
    mulb_, offb = _affine(f, biasb, mulb, addb, dev)
    with torch.cuda.device(dev):
        rc = lib.dpai_fused_up_stage(
            y.data_ptr(), None if sk is None else sk.data_ptr(),
            wa.data_ptr(), mula_.data_ptr(), offa.data_ptr(), wb.data_ptr(),
            mulb_.data_ptr(), offb.data_ptr(), a.data_ptr(), out.data_ptr(),
            n, hh, wh, c, cs, f, int(relu), int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_up_stage: kernel launch failed with CUDA error {rc} "
            f"(N={n} Hh={hh} Wh={wh} C={c} Cs={cs} F={f})")
    fused_up_stage.launches += 1
    return out


fused_up_stage.launches = 0
