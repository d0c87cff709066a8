"""DenseNet-121 U-Net in PyTorch, NHWC, bf16 compute with f32 parameters.

Port of the canonical forward of ``digipathai_tpu/models/densenet_unet.py``:
a DenseNet-121 encoder (blocks [6, 12, 24, 16], growth 32, 0.5
transitions, BN eps 1.001e-5) and a 5-stage nearest-upsample U-Net decoder
(320/256/128/96/64 conv + BN(1e-3) + relu blocks) with a 2-class softmax.

Every 3x3 convolution runs through a hand-written kernel:
- the dense layer's BN -> relu -> 3x3 conv runs ``ops.conv_fused.
  fused_conv3x3`` with the BN folded into its pre-activation (as
  ``dense_block_chunked`` does with ``pallas_blocks``);
- each decoder conv block is conv + bias with the BN folded into the
  kernel's epilogue affine (as ``fused_decoder`` does);
- with ``fused_stages=k`` and a single input (N == 1, a tile-mode
  supertile), the last k decoder stages each run as one
  ``ops.stage_fused.fused_up_stage`` (as the JAX model's ``fused_stages``
  does); at N > 1 the decoder above runs instead, as in JAX.

Each kernel takes its operands prepared once
(``conv_fused.prepare``: the bf16 kernel packed for its plan, the folded
affine, the pre-affine; convA's kernel folded for the upsample), cached per
conv and rebuilt when one of its parameters changes (keyed on each
parameter's device, ``data_ptr`` and ``_version``), so weights loaded after
a first forward take effect.  On a CPU input the wrappers run their plain
versions on the operands' raw parameters.

The JAX model's TPU layout options (``halo_crop``, ``s2d_stem``, ``wpack``,
``s2d_decoder``) are exact rewrites; they are accepted and the canonical
form runs.  ``s2d_decoder`` keeps JAX's one side effect: it turns
``fused_stages`` off.

Submodules carry the Keras/flax names (``conv2_block1_1_conv``, ``conv2d_3``,
``batch_normalization_7``, ...) and parameters keep flax's layouts (HWIO
kernels), so ``bridge.flax_to_torch`` is a name-to-name copy.  Activations
stay NHWC-contiguous; the stem conv and the pools run on NCHW views of them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv_fused, stage_fused
from ..ops.stage_fused import upsample2x

BN_EPS_DENSE = 1.001e-5
BN_EPS_DECODER = 1e-3


class Conv(nn.Module):
    """Conv parameters as flax stores them: ``kernel`` (kh, kw, cin, cout)
    and an optional ``bias`` (cout,)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int,
                 use_bias: bool = True, init_scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kh, kw, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
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
    """Inference BatchNorm: ``scale``/``bias`` parameters and ``mean``/``var``
    buffers, under flax's names."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def params(self):
        """Every tensor the folded affine depends on."""
        return (self.scale, self.bias, self.mean, self.var)

    def folded(self):
        """(mul, add), f32: BN(x) == x * mul + add."""
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        return mul, self.bias - self.mean * mul

    def forward(self, x, relu: bool = False):
        """flax's BatchNorm on an x.dtype input: f32 arithmetic, one
        rounding to x.dtype."""
        mul = self.scale * torch.rsqrt(self.var + self.eps)
        y = (x.float() - self.mean) * mul + self.bias
        if relu:
            y = torch.relu(y)
        return y.to(x.dtype)


def conv1x1(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """A 1x1 conv on NHWC is a matmul over channels."""
    y = torch.matmul(x, conv.kernel[0, 0].to(x.dtype))
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


DECODER = (320, 256, 128, 96, 64)  # features per decoder stage


def kernel_calls(n: int, side: int, fused_stages: int = 0,
                 blocks=(6, 12, 24, 16), growth: int = 32):
    """The distinct kernel calls of one forward of an (n, side, side, 3)
    input, in order: ``(kernel, shape, calls)`` with kernel ``"conv"``
    (shape ``(n, h, w, c, f, pre_affine)``) or ``"stage"`` (shape ``(n, hh,
    wh, c, cs, f)``).  ``fused_stages`` applies at n == 1, as in forward."""
    out = []
    r, c = side // 4, 64
    skips = [(side // 2, 64)]
    for bi, nl in enumerate(blocks):
        out.append(("conv", (n, r, r, 4 * growth, growth, True), nl))
        c += nl * growth
        if bi < len(blocks) - 1:
            skips.append((r, c))
            r, c = r // 2, c // 2
    n_fused = min(fused_stages, len(DECODER)) if n == 1 else 0
    for si, (feats, skip) in enumerate(zip(DECODER, skips[::-1] + [None])):
        cs = 0 if skip is None else skip[1]
        if si >= len(DECODER) - n_fused:
            out.append(("stage", (n, r, r, c, cs, feats), 1))
        else:
            out.append(("conv", (n, 2 * r, 2 * r, c, feats, False), 1))
            out.append(("conv", (n, 2 * r, 2 * r, feats + cs, feats, False),
                        1))
        r, c = 2 * r, feats
    return out


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init of every Conv/BatchNorm of ``module``, in
    registration order, from one ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(g)
    return module


class DenseNet121UNet(nn.Module):
    """(N, H, W, 3) normalized patches -> (N, H, W, num_classes) f32 softmax."""

    def __init__(self, blocks=(6, 12, 24, 16), growth: int = 32,
                 num_classes: int = 2, dtype=torch.bfloat16,
                 fused_stages: int = 0, halo_crop: int = 0, s2d_stem: int = 0,
                 wpack: bool = False, s2d_decoder: bool = False):
        super().__init__()
        self.blocks = tuple(blocks)
        self.growth = growth
        self.dtype = dtype
        self.fused_stages = 0 if s2d_decoder else int(fused_stages)
        add = self.add_module
        add("conv1__conv", Conv(7, 7, 3, 64, use_bias=False))
        add("conv1__bn", BatchNorm(64, BN_EPS_DENSE))
        c = 64
        skips = [64]  # channels of conv1, conv2, conv3, conv4
        for bi, n in enumerate(self.blocks):
            name = f"conv{bi + 2}"
            for i in range(n):
                ln = f"{name}_block{i + 1}"
                add(f"{ln}_0_bn", BatchNorm(c, BN_EPS_DENSE))
                add(f"{ln}_1_conv", Conv(1, 1, c, 4 * growth, use_bias=False))
                add(f"{ln}_1_bn", BatchNorm(4 * growth, BN_EPS_DENSE))
                add(f"{ln}_2_conv", Conv(3, 3, 4 * growth, growth,
                                         use_bias=False))
                c += growth
            if bi < len(self.blocks) - 1:
                skips.append(c)
                add(f"pool{bi + 2}_bn", BatchNorm(c, BN_EPS_DENSE))
                add(f"pool{bi + 2}_conv", Conv(1, 1, c, c // 2, use_bias=False))
                c //= 2
        add("bn", BatchNorm(c, BN_EPS_DENSE))
        # decoder: (features, skip channels) per stage, deepest first
        self.stages = list(zip(DECODER, skips[::-1] + [0]))
        ci = 0
        for feats, cs in self.stages:
            for cin in (c, feats + cs):
                add("conv2d" if ci == 0 else f"conv2d_{ci}",
                    Conv(3, 3, cin, feats, init_scale=2.0))
                add("batch_normalization" if ci == 0
                    else f"batch_normalization_{ci}",
                    BatchNorm(feats, BN_EPS_DECODER))
                ci += 1
            c = feats
        add(f"conv2d_{ci}", Conv(1, 1, c, num_classes))
        self._prepared = {}  # name -> (stamp, operands): see _operands

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

    def _dense_block(self, x, n, name):
        """Dense block with its concat preallocated: layer i reads the first
        C0 + 32 i channels and writes its 32 new ones after them."""
        dt = self.dtype
        nb, h, w, c = x.shape
        buf = x.new_empty(nb, h, w, c + n * self.growth)
        buf[..., :c] = x
        for i in range(n):
            ln = f"{name}_block{i + 1}"
            # BN0 -> relu in dt arithmetic (the JAX chunked encoder's form),
            # then the 1x1 conv with f32 accumulation and one rounding
            bn0 = getattr(self, f"{ln}_0_bn")
            mul0, add0 = self._operands(
                f"{ln}_0", bn0.params(),
                lambda: tuple(t.to(dt) for t in bn0.folded()))
            hpre = torch.relu(buf[..., :c] * mul0 + add0)
            y = conv1x1(hpre, getattr(self, f"{ln}_1_conv"))
            bn1 = getattr(self, f"{ln}_1_bn")
            kernel = getattr(self, f"{ln}_2_conv").kernel
            ops = self._operands(
                f"{ln}_2", (kernel, *bn1.params()),
                lambda: conv_fused.prepare(
                    kernel, None, None, None, *bn1.folded(), dtype=dt,
                    device=y.device))
            buf[..., c:c + self.growth] = conv_fused.fused_conv3x3(
                y, ops, relu=False)
            c += self.growth
        return buf

    def _transition(self, x, name):
        y = getattr(self, f"{name}_bn")(x, relu=True)
        y = conv1x1(y, getattr(self, f"{name}_conv"))
        return _nhwc(F.avg_pool2d(_nchw(y), 2))

    def _decoder_modules(self, i):
        conv = getattr(self, "conv2d" if i == 0 else f"conv2d_{i}")
        bn = getattr(self, "batch_normalization" if i == 0
                     else f"batch_normalization_{i}")
        return conv, bn

    def _decoder_params(self, i):
        """(kernel, bias, mul, add) of decoder conv block i, BN folded."""
        conv, bn = self._decoder_modules(i)
        return (conv.kernel, conv.bias, *bn.folded())

    def _decoder_stamp(self, *blocks):
        return [p for i in blocks for m in self._decoder_modules(i)
                for p in m.params()]

    def _conv_block(self, x, i):
        ops = self._operands(
            f"decoder{i}", self._decoder_stamp(i),
            lambda: conv_fused.prepare(*self._decoder_params(i),
                                       dtype=self.dtype, device=x.device))
        return conv_fused.fused_conv3x3(x, ops)

    def _fused_stage(self, y, skip, i):
        """Decoder conv blocks i and i + 1 as one fused_up_stage."""
        skip = None if skip is None else skip.to(self.dtype)
        opa, opb = self._operands(
            f"stage{i}", self._decoder_stamp(i, i + 1),
            lambda: stage_fused.prepare_stage(
                *self._decoder_params(i), *self._decoder_params(i + 1),
                dtype=self.dtype, device=y.device))
        return stage_fused.fused_up_stage(y, opa, None, None, None, opb,
                                          None, None, None, skip)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        k = self.conv1__conv.kernel.to(dt).permute(3, 2, 0, 1)
        y = _nhwc(F.conv2d(_nchw(x), k, stride=2, padding=3))
        y = self.conv1__bn(y, relu=True)
        conv1 = y
        # zero pad == -inf pad here: the input is post-relu
        y = _nhwc(F.max_pool2d(_nchw(y), 3, stride=2, padding=1))
        skips = [conv1]
        for bi, n in enumerate(self.blocks):
            y = self._dense_block(y, n, f"conv{bi + 2}")
            if bi < len(self.blocks) - 1:
                skips.append(y)
                y = self._transition(y, f"pool{bi + 2}")
        y = self.bn(y)  # no relu after 'bn', faithful to the reference

        n_fused = (min(self.fused_stages, len(self.stages))
                   if x.shape[0] == 1 else 0)
        first_fused = len(self.stages) - n_fused
        ci = 0
        for si, skip in enumerate(skips[::-1] + [None]):
            if si >= first_fused:
                y = self._fused_stage(y, skip, ci)
            else:
                y = self._conv_block(upsample2x(y), ci)
                if skip is not None:
                    y = torch.cat([y, skip.to(dt)], dim=-1)
                y = self._conv_block(y, ci + 1)
            ci += 2
        logits = conv1x1(y, getattr(self, f"conv2d_{ci}"))
        return torch.softmax(logits.float(), dim=-1)
