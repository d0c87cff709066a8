"""DenseNet-121 U-Net in PyTorch, NHWC, bf16 compute with f32 parameters.

Port of the canonical forward of ``digipathai_tpu/models/densenet_unet.py``:
a DenseNet-121 encoder (blocks [6, 12, 24, 16], growth 32, 0.5
transitions, BN eps 1.001e-5) and a 5-stage nearest-upsample U-Net decoder
(320/256/128/96/64 conv + BN(1e-3) + relu blocks) with a 2-class softmax.

Every 3x3 convolution runs through a hand-written kernel:
- the dense layer's BN -> relu -> 3x3 conv runs ``ops.conv_fused.
  fused_conv3x3`` with the BN folded into its pre-activation (as
  ``dense_block_chunked`` does with ``pallas_blocks``);
- the decoder is the one both U-Nets share (``unet_decoder.KernelUNet``):
  its conv blocks on ``fused_conv3x3``, and with ``fused_stages=k`` at
  N == 1 its last k stages on ``ops.stage_fused.fused_up_stage``.

Each kernel takes its operands prepared once and cached
(``KernelUNet._operands``).  On a CPU input the wrappers run their plain
versions on the operands' raw parameters.

In train mode the forward is JAX's canonical one and runs no kernel: each
dense layer is BN -> relu -> 1x1 conv -> BN -> relu -> 3x3 ``F.conv2d``,
then the concat (JAX's ``dense_layer``), every BatchNorm on the batch's
statistics, and the decoder's train path (``unet_decoder``).

``quantized`` (``models/quant.py``) runs JAX's int8 set: of the encoder,
the transitions whose 1x1 conv has ``min(cin, cout) >= 192`` (pool3 and
pool4; no dense-layer conv qualifies), and the decoder's eligible conv
blocks (``unet_decoder``).  Every other conv stays on the kernel.

The JAX model's TPU layout options (``halo_crop``, ``s2d_stem``, ``wpack``,
``s2d_decoder``) are exact rewrites; they are accepted and the canonical
form runs.  ``s2d_decoder`` keeps JAX's one side effect: it turns
``fused_stages`` off.

Submodules carry the Keras/flax names (``conv2_block1_1_conv``, ``conv2d_3``,
``batch_normalization_7``, ...) and parameters keep flax's layouts (HWIO
kernels), so ``bridge.flax_to_torch`` is a name-to-name copy.  Activations
stay NHWC-contiguous; the stem conv and the pools run on NCHW views of them,
and every spatial op goes through ``parallel/spatial.py`` (row sharded, a
dense block runs on its strip and a halo as deep as its layers).
"""

from __future__ import annotations

import torch

from ..ops import conv_fused
from ..parallel import channels, spatial
from .keras_names import KerasNamer
from .unet_decoder import (BatchNorm, Conv, KernelUNet, conv1x1, conv_same,
                           decoder_calls, init_params)

__all__ = ["DenseNet121UNet", "init_params", "kernel_calls"]

BN_EPS_DENSE = 1.001e-5


def kernel_calls(n: int, side: int, fused_stages: int = 0,
                 blocks=(6, 12, 24, 16), growth: int = 32, quantized=False):
    """The distinct kernel calls of one forward of an (n, side, side, 3)
    input, in order: ``(kernel, shape, calls)`` with kernel ``"conv"``
    (shape ``(n, h, w, c, f, pre_affine)``) or ``"stage"`` (shape ``(n, hh,
    wh, c, cs, f)``).  ``fused_stages`` applies at n == 1, as in forward;
    ``quantized`` drops the decoder's int8 conv blocks."""
    out = []
    r, c = side // 4, 64
    skips = [64]
    for bi, nl in enumerate(blocks):
        out.append(("conv", (n, r, r, 4 * growth, growth, True), nl))
        c += nl * growth
        if bi < len(blocks) - 1:
            skips.append(c)
            r, c = r // 2, c // 2
    return out + decoder_calls(n, side, c, skips[::-1], fused_stages,
                               quantized)


class DenseNet121UNet(KernelUNet):
    """(N, H, W, 3) normalized patches -> (N, H, W, num_classes) f32 softmax."""

    def __init__(self, blocks=(6, 12, 24, 16), growth: int = 32,
                 num_classes: int = 2, dtype=torch.bfloat16,
                 fused_stages: int = 0, halo_crop: int = 0, s2d_stem: int = 0,
                 wpack: bool = False, s2d_decoder: bool = False,
                 quantized=False):
        super().__init__(dtype, 0 if s2d_decoder else fused_stages,
                         quantized)
        self.blocks = tuple(blocks)
        self.growth = growth
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
        # every encoder layer is named: the decoder's names start at conv2d
        self._add_decoder(c, skips[::-1], KerasNamer(), num_classes)

    def _dense_block(self, x, n, name):
        """Dense block with its concat preallocated: layer i reads the first
        C0 + 32 i channels and writes its 32 new ones after them.  Row
        sharded, the strip takes n rows of halo once and its n layers run
        on it with no exchange (each 3x3 conv spoils one row at the
        extended edges), then the block keeps the strip's own rows."""
        x, keep = spatial.halo(x, n)
        with spatial.local():
            return keep(self._dense_layers(x, n, name))

    def _dense_layers(self, x, n, name):
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
            buf[..., c:c + self.growth] = spatial.fused_conv3x3(
                y, ops, relu=False)
            c += self.growth
        return buf

    def _dense_block_train(self, x, n, name):
        """JAX's canonical ``dense_block``: each layer BN -> relu -> 1x1
        conv -> BN -> relu -> 3x3 conv, concatenated onto its input."""
        for i in range(n):
            ln = f"{name}_block{i + 1}"
            y = getattr(self, f"{ln}_0_bn")(x, relu=True)
            y = conv1x1(y, getattr(self, f"{ln}_1_conv"))
            y = getattr(self, f"{ln}_1_bn")(y, relu=True)
            y = conv_same(y, getattr(self, f"{ln}_2_conv"), self.dtype)
            x = torch.cat([x, y], dim=-1)
        return x

    def _transition(self, x, name):
        y = getattr(self, f"{name}_bn")(x, relu=True)
        conv = f"{name}_conv"
        y = (self._qconv(y, conv) if self._quantizes(conv)
             else conv1x1(y, getattr(self, conv)))
        return spatial.avg_pool2d(y, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        kernel = self.conv1__conv.kernel
        y = channels.gather(spatial.conv2d(
            x, kernel.to(dt).permute(3, 2, 0, 1), stride=2, padding=3),
            kernel)
        y = self.conv1__bn(y, relu=True)
        conv1 = y
        # zero pad == -inf pad here: the input is post-relu
        y = spatial.max_pool2d(y, 3, stride=2, padding=1)
        skips = [conv1]
        dense_block = (self._dense_block_train if self.training
                       else self._dense_block)
        for bi, n in enumerate(self.blocks):
            y = dense_block(y, n, f"conv{bi + 2}")
            if bi < len(self.blocks) - 1:
                skips.append(y)
                y = self._transition(y, f"pool{bi + 2}")
        y = self.bn(y)  # no relu after 'bn', faithful to the reference
        return self._decode(y, skips[::-1], x.shape[0])
