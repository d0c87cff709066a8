"""Inception-ResNet-v2 U-Net in PyTorch, NHWC, bf16 compute with f32 parameters.

Port of the canonical inference forward of
``digipathai_tpu/models/inception_unet.py``: an IRv2 encoder (stem,
mixed_5b, 10 x block35 at 0.17, mixed_6a, 20 x block17 at 0.1, mixed_7a,
9 x block8 at 0.2 and block8_10 at 1.0 without activation, conv_7b 1536)
and the U-Net decoder the DenseNet variant has
(``unet_decoder.KernelUNet``), ending in a 2-class softmax.

- **Names.** Keras names its unnamed layers in creation order (``conv2d_N``,
  ``batch_normalization_N``); the modules are registered through
  ``KerasNamer`` in JAX's declaration order, so ``bridge.flax_to_torch``
  loads the JAX tree name to name.  Encoder BatchNorms have no ``scale``
  (Keras ``scale=False``, eps 1e-3); residual projections have a bias and
  no BN.
- **Rounding, as the JAX engine's default (``packed_heads=True``).** The
  branch convs of mixed_5b, block35/17/8 and mixed_7a apply their BN
  folded into ``y * m + a`` in the compute dtype; the stem, mixed_5b's
  pool branch, mixed_6a and conv_7b apply flax's BatchNorm (f32
  arithmetic, one rounding).  Parallel 1x1 heads that share an input run
  as one matmul: each output channel keeps its own dot.
- **SAME padding at stride 2 is asymmetric**: flax pads (0, 1) on an even
  side, where ``padding=1`` would pad (1, 1) and shift the grid; the
  stride-2 convs and max pools pad explicitly (``same_pad``).
- **Spatial ops** (convs, pools, ``same_pad``) go through
  ``parallel/spatial.py``, so the model also runs row-sharded.
- **``quantized``** (``models/quant.py``) drops the packed heads, as JAX
  does: every branch conv then runs alone and applies flax's BatchNorm
  (f32, one rounding) to its conv's output in the compute dtype, JAX's
  canonical path.  The convs with ``min(cin, cout) >= 192`` run in int8
  (mixed_6a, block17's 1088 -> 192 head and projection, mixed_7a, block8,
  conv_7b and the decoder's eligible conv blocks); every other conv stays
  exact.
- **Train mode** runs JAX's unpacked ``conv2d_bn`` path too (JAX's
  ``use_pack`` is off in train mode), every BatchNorm on the batch's
  statistics, and the decoder's train path: no kernel runs.
- **The decoder** runs every conv block on ``fused_conv3x3`` at any N (JAX
  takes its Pallas conv only at N == 1 with C, F <= 128; ROADMAP.md §C,
  decoder conv rounding), and with ``fused_stages=k`` at N == 1 its last k
  stages on ``fused_up_stage``, as JAX does.

The TPU layout options (``wpack``, ``s2d_decoder``, ``s2d_stem``,
``halo_crop``) and the measurement knob ``trunc_last`` are accepted and
the canonical form runs;
``s2d_decoder`` keeps JAX's one side effect: it turns ``fused_stages``
off.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..parallel import channels, spatial
from .keras_names import KerasNamer
from .unet_decoder import (BatchNorm, Conv, KernelUNet, conv1x1,
                           decoder_calls, same_pad, torch_kernel)

__all__ = ["InceptionResNetV2UNet", "kernel_calls"]

BN_EPS = 1e-3
SKIPS = (1088, 320, 192, 64)  # conv4, conv3, conv2, conv1 channels
TOP = 1536                    # conv_7b


def kernel_calls(n: int, side: int, fused_stages: int = 0, quantized=False):
    """The distinct kernel calls of one forward of an (n, side, side, 3)
    input, as ``densenet_unet.kernel_calls`` lists them: the encoder runs
    on cuDNN and cuBLAS, so these are the decoder's."""
    return decoder_calls(n, side, TOP, SKIPS, fused_stages, quantized)


class CB(NamedTuple):
    """One encoder conv + BN(scale=False) pair and how it strides."""
    conv: str
    bn: str
    kh: int
    kw: int
    stride: int


class InceptionResNetV2UNet(KernelUNet):
    """(N, H, W, 3) normalized patches -> (N, H, W, num_classes) f32 softmax;
    H and W multiples of 32."""

    def __init__(self, num_classes: int = 2, dtype=torch.bfloat16,
                 fused_stages: int = 0, s2d_decoder: bool = False,
                 wpack: bool = False, trunc_last: int = 0,
                 halo_crop: int = 0, s2d_stem: int = 0, quantized=False):
        super().__init__(dtype, 0 if s2d_decoder else fused_stages,
                         quantized)
        namer = KerasNamer()

        def cb(cin, cout, kh, kw=None, stride=1, name=None):
            conv = name if name is not None else namer.conv()
            bn = name + "_bn" if name is not None else namer.bn()
            kw = kh if kw is None else kw
            self.add_module(conv, Conv(kh, kw, cin, cout, use_bias=False))
            self.add_module(bn, BatchNorm(cout, BN_EPS, use_scale=False))
            return CB(conv, bn, kh, kw, stride)

        def residual(name, cin, cout):
            self.add_module(name, Conv(1, 1, cin, cout))
            return name

        self.stem = [cb(3, 32, 3, stride=2), cb(32, 32, 3), cb(32, 64, 3)]
        self.stem2 = [cb(64, 80, 1), cb(80, 192, 3)]
        self.mixed_5b = ([cb(192, 96, 1)], [cb(192, 48, 1), cb(48, 64, 5)],
                         [cb(192, 64, 1), cb(64, 96, 3), cb(96, 96, 3)])
        self.mixed_5b_pool = cb(192, 64, 1)
        self.block35 = [(
            [cb(320, 32, 1)], [cb(320, 32, 1), cb(32, 32, 3)],
            [cb(320, 32, 1), cb(32, 48, 3), cb(48, 64, 3)],
            residual(f"block35_{i}_conv", 128, 320)) for i in range(1, 11)]
        self.mixed_6a = ([cb(320, 384, 3, stride=2)],
                         [cb(320, 256, 1), cb(256, 256, 3),
                          cb(256, 384, 3, stride=2)])
        self.block17 = [(
            [cb(1088, 192, 1)],
            [cb(1088, 128, 1), cb(128, 160, 1, 7), cb(160, 192, 7, 1)],
            residual(f"block17_{i}_conv", 384, 1088)) for i in range(1, 21)]
        self.mixed_7a = ([cb(1088, 256, 1), cb(256, 384, 3, stride=2)],
                         [cb(1088, 256, 1), cb(256, 288, 3, stride=2)],
                         [cb(1088, 256, 1), cb(256, 288, 3),
                          cb(288, 320, 3, stride=2)])
        self.block8 = [(
            [cb(2080, 192, 1)],
            [cb(2080, 192, 1), cb(192, 224, 1, 3), cb(224, 256, 3, 1)],
            residual(f"block8_{i}_conv", 448, 2080)) for i in range(1, 11)]
        self.top = cb(2080, TOP, 1, name="conv_7b")
        self._add_decoder(TOP, SKIPS, namer, num_classes)

    # --- encoder ---------------------------------------------------------

    def _conv(self, x, p: CB):
        """The conv of ``p`` in the compute dtype, no BN: a matmul for 1x1,
        else ``F.conv2d`` with SAME padding (explicit at stride 2)."""
        if self._quantizes(p.conv):
            return self._qconv(x, p.conv, stride=p.stride)
        conv = getattr(self, p.conv)
        if p.kh == p.kw == 1 and p.stride == 1:
            return conv1x1(x, conv)
        w = self._operands(p.conv, (conv.kernel,),
                           lambda: torch_kernel(conv.kernel, self.dtype))
        if p.stride == 1:
            y = spatial.conv2d(x, w, padding=(p.kh // 2, p.kw // 2))
        else:
            y = spatial.conv2d(same_pad(x, p.kh, p.kw, p.stride), w,
                               stride=p.stride)
        return channels.gather(y, conv.kernel)

    def _conv_bn(self, x, p: CB):
        """conv -> flax BatchNorm (f32 arithmetic, one rounding) -> relu."""
        return getattr(self, p.bn)(self._conv(x, p), relu=True)

    def _folded(self, p: CB):
        """The BN of ``p`` folded to (mul, add) in the compute dtype."""
        bn = getattr(self, p.bn)
        return self._operands(p.bn, bn.params(), lambda: tuple(
            t.to(self.dtype) for t in bn.folded()))

    def _conv_folded(self, x, p: CB):
        """conv -> ``y * m + a`` in the compute dtype -> relu (JAX's
        ``cb_apply``)."""
        m, a = self._folded(p)
        return torch.relu(self._conv(x, p) * m + a)

    def _heads(self, x, ps) -> Tuple[torch.Tensor, ...]:
        """Parallel 1x1 heads on one input as one matmul, the folded BN
        and relu on the packed output, split per head (JAX's
        ``cb_packed``)."""
        convs = [getattr(self, p.conv) for p in ps]
        key = "+".join(p.conv for p in ps)
        w, m, a = self._operands(
            key, [t for p, c in zip(ps, convs)
                  for t in (c.kernel, *getattr(self, p.bn).params())],
            lambda: (torch.cat([c.kernel[0, 0] for c in convs], -1).to(
                self.dtype), *(torch.cat(t) for t in zip(
                    *(self._folded(p) for p in ps)))))
        y = torch.relu(torch.matmul(x, w) * m + a)
        return torch.split(y, [c.kernel.shape[-1] for c in convs], dim=-1)

    def _branches(self, x, branches):
        """Branches whose first convs are 1x1 heads on x, each followed by
        its own chain of folded convs; quantized or in train mode, each conv
        alone with flax's BatchNorm (JAX's unpacked ``conv2d_bn``)."""
        if self.quantized or self.training:
            outs = []
            for b in branches:
                h = x
                for p in b:
                    h = self._conv_bn(h, p)
                outs.append(h)
            return outs
        heads = self._heads(x, [b[0] for b in branches])
        outs = []
        for h, b in zip(heads, branches):
            for p in b[1:]:
                h = self._conv_folded(h, p)
            outs.append(h)
        return outs

    def _residual(self, x, branches, conv, scale, relu=True):
        mixed = torch.cat(branches, dim=-1)
        up = (self._qconv(mixed, conv) if self._quantizes(conv)
              else conv1x1(mixed, getattr(self, conv)))
        # the scale rounds to the compute dtype first, as JAX's weakly
        # typed Python float does
        y = x + up * float(torch.tensor(scale).to(self.dtype))
        return torch.relu(y) if relu else y

    @staticmethod
    def _maxpool(x):
        # a zero pad equals flax's -inf pad here: every input is post-relu
        return spatial.max_pool2d(same_pad(x, 3, 3, 2), 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = x
        for p in self.stem:
            y = self._conv_bn(y, p)
        conv1 = y
        y = self._maxpool(y)
        for p in self.stem2:
            y = self._conv_bn(y, p)
        conv2 = y
        y = self._maxpool(y)

        # mixed_5b; TF average pooling excludes padded cells from the mean
        bp = spatial.avg_pool2d(y, 3, stride=1, padding=1,
                                count_include_pad=False)
        y = torch.cat([*self._branches(y, self.mixed_5b),
                       self._conv_bn(bp, self.mixed_5b_pool)], dim=-1)
        for *branches, conv in self.block35:
            y = self._residual(y, self._branches(y, branches), conv, 0.17)
        conv3 = y

        b0, b1 = self.mixed_6a
        outs = [self._conv_bn(y, b0[0])]
        h = y
        for p in b1:
            h = self._conv_bn(h, p)
        y = torch.cat([*outs, h, self._maxpool(y)], dim=-1)  # 1088
        for *branches, conv in self.block17:
            y = self._residual(y, self._branches(y, branches), conv, 0.1)
        conv4 = y

        y = torch.cat([*self._branches(y, self.mixed_7a), self._maxpool(y)],
                      dim=-1)  # 2080
        for i, (*branches, conv) in enumerate(self.block8):
            last = i == len(self.block8) - 1
            y = self._residual(y, self._branches(y, branches), conv,
                               1.0 if last else 0.2, relu=not last)
        y = self._conv_bn(y, self.top)
        return self._decode(y, [conv4, conv3, conv2, conv1], x.shape[0])
