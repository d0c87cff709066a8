"""Fused 3x3 conv + bias + BN-affine + relu: the Hopper kernel and its plain twin.

``fused_conv3x3`` computes ``relu((conv3x3_same(h, k) + bias) * mul + add)``
on NHWC tensors, where ``h = relu(x * pre_mul + pre_add)`` when a
pre-affine is given and ``h = x`` otherwise; the SAME halo is zero after the
pre-activation.  It is both the DenseNet dense layer's BN -> relu -> 3x3 conv
and the U-Net decoder's conv + bias + BN + relu block.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/conv_fused.py``
(``fused_conv3x3``, N=1 only) with ``csrc/conv_fused.cu``: an implicit-GEMM
conv (M = N*H*W pixels, K = 9*C, tensor-core ``mma.sync`` in bf16 with f32
accumulation) that takes any N >= 1 and any C and F.  At batch 32 the
decoder's wide convs are compute-bound on the H100, so the kernel keeps the
tensor cores fed from double-buffered shared-memory tiles and fuses the
pre-activation into the tile load and the affine/relu into the epilogue, so
neither makes an extra pass over device memory.

Dispatch: a CPU tensor runs ``fused_conv3x3_plain``; a CUDA tensor launches
the kernel or raises.  ``fused_conv3x3.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = (torch.float32, torch.bfloat16)


def _affine(f, bias, mul, add, device):
    mul_ = (torch.ones(f, device=device) if mul is None
            else mul.to(device, torch.float32))
    off = (torch.zeros(f, device=device) if add is None
           else add.to(device, torch.float32))
    if bias is not None:
        off = off + bias.to(device, torch.float32) * mul_
    return mul_.contiguous(), off.contiguous()


def _pre(c, pre_mul, pre_add, dtype, device):
    """The pre-affine in the activation's type, or (None, None)."""
    if pre_mul is None and pre_add is None:
        return None, None
    pm = torch.ones(c) if pre_mul is None else pre_mul
    pa = torch.zeros(c) if pre_add is None else pre_add
    return (pm.to(device, dtype).contiguous(),
            pa.to(device, dtype).contiguous())


def fused_conv3x3_plain(x, k, bias=None, mul=None, add=None, *, relu=True,
                        pre_mul=None, pre_add=None):
    """Plain PyTorch version: pre-activation, zero pad, ``F.conv2d``,
    affine, relu.  x: (N, H, W, C); k: (3, 3, C, F) -> (N, H, W, F) x.dtype."""
    dt = x.dtype
    pm, pa = _pre(x.shape[-1], pre_mul, pre_add, dt, x.device)
    h = x if pm is None else torch.relu(x * pm + pa)
    y = F.conv2d(h.permute(0, 3, 1, 2), k.to(x.device, dt).permute(3, 2, 0, 1),
                 padding=1)
    mul_, off = _affine(k.shape[-1], bias, mul, add, x.device)
    y = y.permute(0, 2, 3, 1).float() * mul_ + off
    if relu:
        y = torch.relu(y)
    return y.to(dt).contiguous()


def fused_conv3x3(x, k, bias=None, mul=None, add=None, *, relu=True,
                  pre_mul=None, pre_add=None):
    """``relu((conv3x3_same(h, k) + bias) * mul + add)``, NHWC.

    x: (N, H, W, C) float32 or bfloat16; k: (3, 3, C, F); bias/mul/add:
    (F,) or None; pre_mul/pre_add: (C,) or None.  Returns (N, H, W, F) in
    x.dtype.  The conv accumulates in f32; in bf16 the pre-activation rounds
    after the multiply and after the add, as the plain version does.
    """
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, k, bias, mul, add, relu=relu,
                                   pre_mul=pre_mul, pre_add=pre_add)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not in {_DTYPES}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_conv3x3: x must be a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if k.dim() != 4 or tuple(k.shape[:3]) != (3, 3, c):
        raise ValueError(f"fused_conv3x3: kernel shape {tuple(k.shape)} is "
                         f"not (3, 3, {c}, F)")
    f = k.shape[-1]
    for name, v, size in (("bias", bias, f), ("mul", mul, f), ("add", add, f),
                          ("pre_mul", pre_mul, c), ("pre_add", pre_add, c)):
        if v is not None and tuple(v.shape) != (size,):
            raise ValueError(f"fused_conv3x3: {name} shape {tuple(v.shape)} "
                             f"!= ({size},)")
    from .. import _build

    lib = _build.load("conv_fused")
    out = torch.empty((n, h, w, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    wk = k.to(x.device, x.dtype).contiguous()
    mul_, off = _affine(f, bias, mul, add, x.device)
    pm, pa = _pre(c, pre_mul, pre_add, x.dtype, x.device)
    with torch.cuda.device(x.device):
        rc = lib.dpai_fused_conv3x3(
            x.data_ptr(), wk.data_ptr(), mul_.data_ptr(), off.data_ptr(),
            None if pm is None else pm.data_ptr(),
            None if pa is None else pa.data_ptr(),
            out.data_ptr(), n, h, w, c, f, int(relu),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv3x3: kernel launch failed with CUDA "
                           f"error {rc} (N={n} H={h} W={w} C={c} F={f})")
    fused_conv3x3.launches += 1
    return out


fused_conv3x3.launches = 0
