"""Int8 quantized inference convs (``quantized=...``), opt in.

The arithmetic of ``digipathai_tpu/models/quant.py``'s ``QuantConv``,
``QuantConvCalib`` and ``QuantConvStatic``:

- **Eligibility.** A conv runs int8 only when it is not grouped, its
  dilation is 1 and ``min(cin, features) >= 192``; every other conv stays
  on its exact path.
- **Weights**, per output channel: ``scale_w[o] = max(max|k[..., o]|,
  1e-12) / 127`` and ``kq = round(k32 / scale_w)``.
- **Activations**, per tensor: ``dynamic`` takes ``scale_x = max(max|x32|,
  1e-12) / 127`` of the whole input of that call; ``calib`` does the same
  and records the running ``amax`` of each conv; ``static`` takes the
  recorded ``amax`` and clips to +-127.  ``round(x32 / scale_x)`` divides
  (no reciprocal multiply) and rounds half to even, as ``jnp.round`` does.
- **The ``/ 127``** of both scales is a multiply by f32(1/127), as XLA
  compiles JAX's division by that constant in the jitted forwards the JAX
  engine runs (eager JAX divides: scales then differ in the last bit).
- **Output**: the integer sum, then ``y_f32 * (scale_x * scale_w) +
  bias_f32``, cast to the model's dtype.  The sum is never rounded to bf16
  before that epilogue.

The integer product is a library call (JAX runs it with
``lax.conv_general_dilated``, outside any Pallas kernel).  Its routes,
counted in ``int8_conv.routes``:

- ``int_mm``: a 1x1 conv on CUDA, ``torch._int_mm`` (int8 x int8 ->
  int32, exact) on (positions, C) x (C, F);
- ``mm_f32``: a 1x1 conv on CUDA with 16 positions or fewer (``_int_mm``
  needs more), an f32 matmul of the integer values;
- ``conv_f32``: a k x k or strided k x k conv on CUDA, ``F.conv2d`` in f32
  on the integer values (|q| <= 127 fits TF32's mantissa, so the products
  are exact with or without TF32, and the sums in f32 are exact below
  2^24);
- ``cpu_f64``: any conv on the CPU, in f64 (exact).

A model built with ``quantized`` keeps its parameter names: the static
ranges are each conv's ``amax``, a buffer outside the module's state (not
in ``state_dict``, the ``.h5`` template or the ``.npz`` cache).
``calibrate`` records them and returns them as JAX's ``calib`` collection,
``{layer: {"amax": ()}}``; ``set_calib`` (and ``bridge.flax_to_torch``)
sets them from one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial

__all__ = ["MIN_CHANNELS", "calibrate", "calib_of", "dequantize",
           "eligible", "int8_conv", "mode_of", "prepare_weight",
           "quantize_activation", "set_calib"]

MIN_CHANNELS = 192
# XLA folds ``a / 127.0`` into ``a * f32(1 / 127)``; as a Python float this
# is that f32 value exactly, so torch's scalar multiply uses it as is
INV127 = float(np.float32(1.0 / 127.0))


def mode_of(quantized) -> Optional[str]:
    """JAX's ``conv_ctor`` switch: a false value -> None (exact convs);
    ``"calib"`` and ``"static"`` as they are; any other true value (True,
    ``"dynamic"``) -> ``"dynamic"``."""
    if not quantized:
        return None
    if quantized in ("calib", "static"):
        return quantized
    return "dynamic"


def eligible(cin: int, features: int, groups: int = 1,
             dilation: int = 1) -> bool:
    """Whether JAX's ``QuantConv`` runs this conv in int8."""
    return (groups == 1 and dilation == 1
            and min(cin, features) >= MIN_CHANNELS)


class QuantWeight(NamedTuple):
    """A conv's int8 weights, laid out for its route on one device."""
    kh: int
    kw: int
    k: torch.Tensor          # 1x1: f64 (C, F), or int8 (F, C) on CUDA;
    #                          else OIHW, f64, or f32 on CUDA
    scale_w: torch.Tensor    # (F,) f32
    bias: Optional[torch.Tensor]     # (F,) f32


def prepare_weight(kernel: torch.Tensor, bias, device) -> QuantWeight:
    """Quantize an HWIO kernel per output channel (on the CPU, in f32, so
    every device gets the same integers) and lay it out for ``device``'s
    route."""
    k32 = kernel.detach().to("cpu", torch.float32)
    kh, kw, c, f = k32.shape
    w_amax = k32.abs().amax(dim=(0, 1, 2))
    scale_w = torch.clamp_min(w_amax, 1e-12) * INV127
    kq = torch.round(k32 / scale_w)
    b = None if bias is None else bias.detach().to(device, torch.float32)
    device = torch.device(device)
    if kh == kw == 1:
        k = kq[0, 0]  # (C, F)
        if device.type == "cuda":
            k = k.t().contiguous().to(device, torch.int8)  # (F, C)
        else:
            k = k.double()
    else:
        k = kq.permute(3, 2, 0, 1)  # OIHW
        if device.type == "cuda":
            k = k.to(device).contiguous(memory_format=torch.channels_last)
        else:
            k = k.double().contiguous()
    return QuantWeight(kh, kw, k, scale_w.to(device), b)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) * INV127


def quantize_activation(x: torch.Tensor, mode: str, conv, name: str = ""):
    """(scale_x, q): the per-tensor scale (a 0-d f32 tensor on x's device)
    and ``round(x32 / scale_x)`` as f32, clipped to +-127 when static.  In
    ``calib`` mode the conv's ``amax`` becomes the running maximum."""
    x32 = x.float()
    if mode == "static":
        if conv.amax is None:
            raise ValueError(
                "quantized='static' needs calibrated variables: run "
                "models.quant.calibrate() first (missing calib/amax for "
                f"{name})")
        scale = _scale(conv.amax.to(x.device, torch.float32))
        return scale, torch.clamp(torch.round(x32 / scale), -127.0, 127.0)
    # over every strip of a row-sharded x (parallel/spatial.py)
    amax = spatial.all_max(x32.abs().amax() if x32.numel()
                           else x32.new_zeros(()))
    if mode == "calib":
        conv.amax = amax if conv.amax is None else torch.maximum(conv.amax,
                                                                 amax)
    scale = _scale(amax)
    return scale, torch.round(x32 / scale)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def int8_conv(q: torch.Tensor, w: QuantWeight, stride: int = 1):
    """The VALID conv at ``stride`` of the integer-valued NHWC ``q`` (padded
    already) with ``w``'s integer kernel -> the f32 sums (N, Ho, Wo, F)."""
    routes = int8_conv.routes
    if w.kh == w.kw == 1:
        if stride > 1:
            q = q[:, ::stride, ::stride]
        n, h, wd, c = q.shape
        a = q.reshape(-1, c)
        if q.device.type == "cpu":
            routes["cpu_f64"] += 1
            acc = (a.double() @ w.k).float()
        elif a.shape[0] > 16 and c % 8 == 0 and w.k.shape[0] % 8 == 0:
            routes["int_mm"] += 1
            acc = torch._int_mm(a.to(torch.int8), w.k.t()).float()
        else:
            routes["mm_f32"] += 1
            acc = a @ w.k.t().float()
        return acc.reshape(n, h, wd, -1)
    if q.device.type == "cpu":
        routes["cpu_f64"] += 1
        return _nhwc(F.conv2d(_nchw(q.double()), w.k, stride=stride)).float()
    routes["conv_f32"] += 1
    return _nhwc(F.conv2d(_nchw(q), w.k, stride=stride))


int8_conv.routes = {"int_mm": 0, "mm_f32": 0, "conv_f32": 0, "cpu_f64": 0}


def dequantize(acc: torch.Tensor, scale: torch.Tensor, w: QuantWeight,
               dtype) -> torch.Tensor:
    """``acc * (scale_x * scale_w) + bias`` in f32, cast to ``dtype``;
    contiguous NHWC."""
    y = acc * (scale * w.scale_w)
    if w.bias is not None:
        y = y + w.bias
    return y.to(dtype).contiguous()


def _convs(module):
    from .unet_decoder import Conv

    return {name: m for name, m in module.named_modules()
            if isinstance(m, Conv)}


def calib_of(module):
    """The recorded ranges as JAX's ``calib`` collection: ``{layer:
    {"amax": f32 ()}}`` for every conv that has one."""
    return {name: {"amax": np.asarray(m.amax.detach().cpu(), np.float32)}
            for name, m in _convs(module).items() if m.amax is not None}


def set_calib(module, calib) -> None:
    """Set each named conv's static range from a ``calib`` collection."""
    convs = _convs(module)
    for name, leaves in calib.items():
        if name not in convs:
            raise KeyError(f"calib names {name!r}, which is no conv of the "
                           f"module")
        m = convs[name]
        m.amax = torch.as_tensor(np.asarray(leaves["amax"], np.float32),
                                 device=m.kernel.device)


def calibrate(module, sample_inputs):
    """Record each eligible conv's activation abs-max over
    ``sample_inputs`` (the maximum over all of them) on the dynamic int8
    path, as JAX's ``calibrate`` does with a ``quantized="calib"`` twin;
    returns the ``calib`` collection and leaves the ranges set on
    ``module``, whose mode is restored.  Fused decoder stages never
    quantize, so the U-Nets calibrate through their canonical decoder: it
    records the ranges of the convs those stages replace as well, and the
    same values for every other conv."""
    convs = _convs(module)
    for m in convs.values():
        m.amax = None
    saved = module.quantized, getattr(module, "fused_stages", None)
    module.quantized = "calib"
    if saved[1] is not None:
        module.fused_stages = 0
    try:
        with torch.inference_mode():
            for x in sample_inputs:
                module(x)
    finally:
        module.quantized = saved[0]
        if saved[1] is not None:
            module.fused_stages = saved[1]
    return calib_of(module)
