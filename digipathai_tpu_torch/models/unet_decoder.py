"""The layers the port's models share, and their common U-Net decoder.

Both U-Nets (``densenet_unet.py``, ``inception_unet.py``) end in the same
5-stage nearest-upsample decoder (320/256/128/96/64 conv + bias + BN(1e-3)
+ relu blocks, then a 1x1 head and a 2-class softmax), as the JAX models
do (``digipathai_tpu/models/inception_unet.py``: "identical scheme to the
DenseNet variant").  ``KernelUNet`` holds it:

- each decoder conv block is conv + bias with the BN folded into the
  epilogue affine of ``ops.conv_fused.fused_conv3x3``;
- with ``fused_stages=k`` and a single input (N == 1, a tile-mode
  supertile), the last k stages each run as one
  ``ops.stage_fused.fused_up_stage``; at N > 1 the blocks above run
  instead, as in JAX.

Each kernel takes its operands prepared once (``conv_fused.prepare``: the
bf16 kernel packed for its plan and the folded affine; convA's kernel
folded for the upsample), cached per conv and rebuilt when one of its
parameters changes (keyed on each parameter's device, ``data_ptr`` and
``_version``), so weights loaded after a first forward take effect.  The
encoders use the same cache (``_operands``) for their own prepared
tensors, and ``quantized`` models for each int8 conv's weights.

Every spatial op of the models (convs, pools, ``same_pad``, upsamples,
resizes, the kernels) goes through ``parallel/spatial.py``, which runs the
op as before on a tensor and row-sharded inside a lockstep run
(``engine/tile_infer.py::build_tile_step_sp``); pointwise and channel ops
run on each strip as they are.  On a (dp, sp, mp) mesh
(``training/train.py::shard_train_step``) each train-mode conv computes
its slice of the output channels and gathers the rest, and each BatchNorm
gathers its affine, through ``parallel/channels.py``.

``quantized`` (``models/quant.py``) runs each eligible conv in int8
(``PreparedModule._qconv``), as JAX's ``QuantConv`` does.  In the decoder
that is every conv block with ``min(cin, F) >= 192`` outside a fused
stage: it leaves ``fused_conv3x3`` for the int8 conv, then flax's f32
BatchNorm and relu, where JAX rounds.  Fused stages never quantize, in JAX
either.

Every model here is built in eval mode, flax's ``train=False``.  In train
mode (``module.train()``) no kernel runs and nothing prepared is
used, as JAX's ``not train`` gates have it: every decoder conv block is
``F.conv2d`` in the compute dtype, the bias in that dtype, ``BatchNorm`` on
the batch's statistics and relu, and no stage is fused.  The kernels have
no backward.

Parameters keep flax's names and layouts (HWIO kernels; BatchNorm
``scale``/``bias`` and ``mean``/``var``), so ``bridge.flax_to_torch`` is a
name-to-name copy.  Activations are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import conv_fused, stage_fused
from ..parallel import channels, spatial
from ..parallel.spatial import same_pad, upsample2x
from . import quant

BN_EPS_DECODER = 1e-3
BN_MOMENTUM = 0.99  # every JAX model's BatchNorm momentum
DECODER = (320, 256, 128, 96, 64)  # features per decoder stage


class Conv(nn.Module):
    """Conv parameters as flax stores them: ``kernel`` (kh, kw, cin, cout)
    and an optional ``bias`` (cout,).  A depthwise conv stores (kh, kw, 1,
    C), as flax does with ``feature_group_count=C``.  ``amax``, the static
    int8 activation range (``quant.calibrate``), is a buffer outside the
    state: None until calibrated."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int,
                 use_bias: bool = True, init_scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kh, kw, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.register_buffer("amax", None, persistent=False)
        self.init_scale = init_scale  # variance scale: 1 lecun, 2 he

    def params(self):
        """The conv's tensors: the kernel and the bias if it has one."""
        return (self.kernel,) if self.bias is None else (self.kernel,
                                                         self.bias)

    def reset_parameters(self, generator: torch.Generator):
        """flax's variance_scaling(scale, "fan_in", "truncated_normal")."""
        kh, kw, cin, _ = self.kernel.shape
        std = (self.init_scale / (kh * kw * cin)) ** 0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class BatchNorm(nn.Module):
    """flax's BatchNorm: ``scale``/``bias`` parameters and ``mean``/``var``
    buffers, under flax's names.  ``use_scale=False`` (Keras
    ``scale=False``) has no ``scale``, as flax then has none.

    At inference it normalizes with ``mean``/``var``.  In train mode it
    normalizes with the batch's statistics as flax's ``_compute_stats``
    takes them (in f32 or wider, E[x] and max(0, E[x^2] - E[x]^2) over
    (N, H, W), the variance biased) and moves ``mean``/``var`` toward them by
    ``BN_MOMENTUM``, in f32 and outside autograd.  Inside a lockstep run the
    per-channel sums add up over every strip and batch shard
    (``spatial.batch_sum``; each strip counts its own rows); ``reduce``,
    when set, sums them over the ranks of a data-parallel step
    (differentiably), so the statistics are the global batch's."""

    def __init__(self, features: int, eps: float, use_scale: bool = True):
        super().__init__()
        self.eps = eps
        self.scale = (nn.Parameter(torch.ones(features)) if use_scale
                      else None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.reduce = None
        self.train(False)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.scale is not None:
                self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def params(self):
        """Every tensor the folded affine depends on."""
        return tuple(t for t in (self.scale, self.bias, self.mean, self.var)
                     if t is not None)

    def _mul(self, var, scale):
        mul = torch.rsqrt(var + self.eps)
        return mul if scale is None else scale * mul

    def folded(self):
        """(mul, add), f32: BN(x) == x * mul + add."""
        mul = self._mul(self.var, self.scale)
        return mul, self.bias - self.mean * mul

    def batch_stats(self, xf):
        """(mean, biased var) of NHWC ``xf`` (f32 or wider) over (N, H, W),
        and the running statistics updated toward them."""
        dims = tuple(range(xf.dim() - 1))
        count = xf.new_full((1,), xf.numel() // xf.shape[-1])
        sums = spatial.batch_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                            count]))
        if self.reduce is not None:
            sums = self.reduce(sums)
        mean, mean2 = (sums[:-1] / sums[-1]).chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = 1.0 - BN_MOMENTUM
            self.mean.copy_(BN_MOMENTUM * self.mean
                            + m * channels.mine(mean, self.mean))
            self.var.copy_(BN_MOMENTUM * self.var
                           + m * channels.mine(var, self.var))
        return mean, var

    def forward(self, x, relu: bool = False):
        """flax's BatchNorm on an x.dtype input: f32 arithmetic, one
        rounding to x.dtype."""
        xf = _at_least_f32(x)
        if self.training:
            mean, var = self.batch_stats(xf)
            scale, bias = channels.whole(self.scale, self.bias)
        else:
            mean, var, scale, bias = self.mean, self.var, self.scale, self.bias
        y = (xf - mean) * self._mul(var, scale) + bias
        if relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x promoted to f32 or wider, as flax promotes BatchNorm's input."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def conv1x1(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """A 1x1 conv on NHWC is a matmul over channels (one rounding), then
    the bias in x.dtype, as flax adds it."""
    y = torch.matmul(x, conv.kernel.flatten(0, 2).to(x.dtype))
    y = y if conv.bias is None else y + conv.bias.to(x.dtype)
    return channels.gather(y, conv.kernel)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def conv_same(x: torch.Tensor, conv: Conv, dtype) -> torch.Tensor:
    """A stride-1 SAME conv of NHWC ``x`` in ``dtype`` (one rounding), then
    the bias in ``dtype``, as flax's ``nn.Conv`` computes it."""
    kh, kw = conv.kernel.shape[:2]
    y = spatial.conv2d(x.to(dtype), torch_kernel(conv.kernel, dtype),
                       padding=(kh // 2, kw // 2))
    y = y if conv.bias is None else y + conv.bias.to(dtype)
    return channels.gather(y, conv.kernel)


def torch_kernel(k: torch.Tensor, dtype) -> torch.Tensor:
    """An HWIO kernel as ``F.conv2d`` takes it: OIHW in ``dtype``, laid out
    channels-last so that cuDNN runs NHWC kernels on NHWC activations."""
    return k.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init of every Conv/BatchNorm of ``module``, in
    registration order, from one ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(g)
    return module


def decoder_calls(n: int, side: int, c: int, skips, fused_stages: int = 0,
                  quantized=False):
    """The decoder's kernel calls for a ``side``^2 input whose encoder ends
    in ``c`` channels at ``side / 32``: ``(kernel, shape, calls)`` with
    kernel ``"conv"`` (shape ``(n, h, w, c, f, False)``) or ``"stage"``
    (shape ``(n, hh, wh, c, cs, f)``).  ``skips``: the skip channels from
    the deepest (at ``side / 16``) to the shallowest (at ``side / 2``).
    ``fused_stages`` applies at n == 1, as in the forward; with
    ``quantized`` the int8 conv blocks launch no kernel."""
    out = []
    r = side // 32
    n_fused = min(fused_stages, len(DECODER)) if n == 1 else 0
    for si, (feats, cs) in enumerate(zip(DECODER, list(skips) + [0])):
        if si >= len(DECODER) - n_fused:
            out.append(("stage", (n, r, r, c, cs, feats), 1))
        else:
            for cin in (c, feats + cs):
                if not (quantized and quant.eligible(cin, feats)):
                    out.append(("conv", (n, 2 * r, 2 * r, cin, feats, False),
                                1))
        r, c = 2 * r, feats
    return out


class PreparedModule(nn.Module):
    """A model in compute dtype ``dtype`` that caches what it prepares from
    its parameters (packed kernels, folded affines, int8 weights) in
    ``_operands``.  ``quantized``: False, or the int8 mode of its eligible
    convs (``quant.mode_of``).  It is built in eval mode (flax's
    ``train=False``); ``.train()`` selects the train path."""

    def __init__(self, dtype, quantized=False):
        super().__init__()
        self.dtype = dtype
        self.quantized = quant.mode_of(quantized)
        self._prepared = {}  # name -> (stamp, operands): see _operands
        self.train(False)

    def _operands(self, key, params, build):
        """``build()``'s result, cached under ``key`` until one of
        ``params`` (or the compute dtype) changes.  With gradients on it is
        built afresh, so the parameters stay in the graph."""
        if torch.is_grad_enabled():
            return build()
        stamp = (self.dtype, tuple((p.device, p.data_ptr(), p._version)
                                   for p in params))
        hit = self._prepared.get(key)
        if hit is None or hit[0] != stamp:
            hit = self._prepared[key] = (stamp, build())
        return hit[1]

    def _quantizes(self, name: str) -> bool:
        """Whether conv ``name`` runs in int8 (quantized, eligible and not
        training, as JAX's ``conv_ctor(False if train ...)``; a depthwise
        kernel has cin 1, so it never does)."""
        k = getattr(self, name).kernel
        return (bool(self.quantized) and not self.training
                and quant.eligible(k.shape[2], k.shape[3]))

    def _qconv(self, x, name: str, stride: int = 1, same: bool = True):
        """Conv ``name`` on NHWC ``x`` in int8: SAME padding (``same``) or
        VALID, bias included, in the compute dtype.  The activation's scale
        is taken over all of x, before any stride."""
        conv = getattr(self, name)
        w = self._operands(f"{name}:int8", conv.params(),
                           lambda: quant.prepare_weight(conv.kernel,
                                                        conv.bias, x.device))
        scale, q = quant.quantize_activation(x, self.quantized, conv, name)
        if same and (stride > 1 or w.kh > 1 or w.kw > 1):
            q = same_pad(q, w.kh, w.kw, stride)
        acc = spatial.valid_rows(q, w.kh, stride,
                                 lambda t: quant.int8_conv(t, w, stride),
                                 cout=conv.kernel.shape[-1], kw=w.kw)
        return quant.dequantize(acc, scale, w, self.dtype)


class KernelUNet(PreparedModule):
    """Base of the U-Nets: the shared decoder.

    A subclass registers its encoder, then calls ``_add_decoder`` with the
    encoder's output channels, its skips' channels and the namer that
    names the decoder's unnamed Keras layers; its forward ends in
    ``_decode``.  ``fused_stages`` is the number of trailing stages run on
    ``fused_up_stage`` at N == 1.
    """

    def __init__(self, dtype, fused_stages: int, quantized=False):
        super().__init__(dtype, quantized)
        self.fused_stages = int(fused_stages)

    def _add_decoder(self, c: int, skips, namer, num_classes: int):
        """Register the decoder: ``skips`` are the skip channels, deepest
        first; conv block i is named by the namer's next conv and BN."""
        self.stages = list(zip(DECODER, list(skips) + [0]))
        self._blocks = []  # (conv name, BN name) per decoder conv block
        for feats, cs in self.stages:
            for cin in (c, feats + cs):
                names = namer.conv(), namer.bn()
                self.add_module(names[0], Conv(3, 3, cin, feats,
                                               init_scale=2.0))
                self.add_module(names[1], BatchNorm(feats, BN_EPS_DECODER))
                self._blocks.append(names)
            c = feats
        self._head = namer.conv()
        self.add_module(self._head, Conv(1, 1, c, num_classes))

    def _decoder_modules(self, i):
        conv, bn = self._blocks[i]
        return getattr(self, conv), getattr(self, bn)

    def _decoder_params(self, i):
        """(kernel, bias, mul, add) of decoder conv block i, BN folded."""
        conv, bn = self._decoder_modules(i)
        return (conv.kernel, conv.bias, *bn.folded())

    def _decoder_stamp(self, *blocks):
        return [p for i in blocks for m in self._decoder_modules(i)
                for p in m.params()]

    def _conv_block(self, x, i):
        conv, bn = self._blocks[i]
        if self.training:
            return getattr(self, bn)(conv_same(x, getattr(self, conv),
                                               self.dtype), relu=True)
        if self._quantizes(conv):
            return getattr(self, bn)(self._qconv(x, conv), relu=True)
        ops = self._operands(
            f"decoder{i}", self._decoder_stamp(i),
            lambda: conv_fused.prepare(*self._decoder_params(i),
                                       dtype=self.dtype, device=x.device))
        return spatial.fused_conv3x3(x, ops)

    def _fused_stage(self, y, skip, i):
        """Decoder conv blocks i and i + 1 as one fused_up_stage."""
        skip = None if skip is None else skip.to(self.dtype)
        opa, opb = self._operands(
            f"stage{i}", self._decoder_stamp(i, i + 1),
            lambda: stage_fused.prepare_stage(
                *self._decoder_params(i), *self._decoder_params(i + 1),
                dtype=self.dtype, device=y.device))
        return spatial.fused_up_stage(y, opa, None, None, None, opb, None,
                                      None, None, skip)

    def _decode(self, y, skips, n: int):
        """The decoder over the encoder output ``y`` and its ``skips``
        (deepest first) of an N = ``n`` input -> (N, H, W, classes) f32
        softmax.  Stages fuse at N == 1 and never in train mode."""
        dt = self.dtype
        n_fused = (min(self.fused_stages, len(self.stages))
                   if n == 1 and not self.training else 0)
        first_fused = len(self.stages) - n_fused
        ci = 0
        for si, skip in enumerate(list(skips) + [None]):
            if si >= first_fused:
                y = self._fused_stage(y, skip, ci)
            else:
                y = self._conv_block(upsample2x(y), ci)
                if skip is not None:
                    y = torch.cat([y, skip.to(dt)], dim=-1)
                y = self._conv_block(y, ci + 1)
            ci += 2
        logits = conv1x1(y, getattr(self, self._head))
        return torch.softmax(logits.float(), dim=-1)
