"""DeepLabv3+ (Xception-65 backbone) in PyTorch, NHWC, bf16 compute with f32
parameters.

Port of ``digipathai_tpu/models/deeplabv3.py``: entry flow (conv1_1 at
stride 2, conv1_2, three conv-shortcut Xception blocks), 16 sum-shortcut
middle-flow units, exit flow (a conv-shortcut block and a depth-activated
block), ASPP (image pooling, a 1x1 branch and three atrous separable
branches at rates 6/12/18 for output stride 16), the concat projection,
the decoder (align-corners x4 upsample, a 48-channel skip projection, two
separable convs), 2-class logits, an align-corners resize to the input
size and a softmax in f32.

DeepLab has no Pallas kernel in JAX: XLA computes its convs, depthwise
convs and resizes.  Here they are ``F.conv2d`` (depthwise with
``groups=C``, dilated with ``dilation``), matmuls for the 1x1 convs, and
``ops.resize.resize_bilinear_align_corners``, each spatial op through
``parallel/spatial.py`` (so the model also runs row-sharded; there the
image pooling's global mean sums each strip in f32 and adds the sums in
strip order).

- **Padding.** ``entry_flow_conv1_1`` is flax SAME at stride 2: (0, 1) on
  an even side (``same_pad``).  The other stride-2 convs pad as the
  reference's ``_conv2d_same`` does, ``(eff - 1) // 2`` before and the rest
  after, then run VALID: (1, 1) for a 3x3 depthwise, (0, 0) for the 1x1
  shortcuts.  Dilated SAME pads ``rate`` on each side.
- **Rounding**: each conv rounds to the compute dtype, each BatchNorm
  computes in f32 and rounds once, as flax does; BN eps is 1e-3 in the
  backbone and 1e-5 in ASPP and the decoder.
- **Image pooling.** ``aspp_pool_window=0`` takes the global mean of the
  features (the reference's 256 px patches); a window (in input pixels)
  takes VALID means over ``window / 16`` blocks (the output stride) and
  repeats each over its block, which keeps the context patch-sized in
  tile mode.
  The window must divide the features, or ``ValueError``.
- **Dropout** (rate ``DROPOUT_RATE``) follows the concat projection. It
  is the identity at inference; in train mode its mask comes from the
  ``torch.Generator`` the caller passes to the forward, and a forward
  without one raises (there is no global RNG).  JAX's train step passes
  no dropout rng, so its DeepLab cannot train (ROADMAP.md §C).
- **Train mode** runs every BatchNorm on the batch's statistics; nothing
  else changes (no conv is quantized, as in JAX).
- **``quantized``** (``models/quant.py``) runs the convs with ``min(cin,
  cout) >= 192`` in int8: the pointwise convs from entry block 2 on, the
  wide shortcuts, and the ASPP's, the projection's and the decoder's
  1x1s.  Depthwise and dilated convs, the narrow entry convs and the
  logits stay exact.  A strided shortcut takes its activation scale over
  its whole input, as JAX's strided conv does.

All Keras layers here are named explicitly, so the parameter names are
JAX's (``bridge.flax_to_torch`` is a name-to-name copy).  The output
stride is 16, as the engine builds the JAX model; ``s2d_stem`` is a TPU
layout rewrite: accepted, and the canonical form runs.
"""

from __future__ import annotations

import torch

from ..parallel import channels, spatial
from ..parallel.spatial import resize_bilinear_align_corners
from .unet_decoder import (BatchNorm, Conv, PreparedModule, conv1x1,
                           same_pad, torch_kernel)

__all__ = ["DeepLabV3Plus"]

OUTPUT_STRIDE = 16  # the engine's: entry block 3 at stride 2, exit rate 2
ATROUS_RATES = (6, 12, 18)
DROPOUT_RATE = 0.1


def dropout(y: torch.Tensor, rate: float, generator: torch.Generator):
    """flax's ``nn.Dropout``: keep each element with probability 1 - rate,
    scaled by 1 / (1 - rate) in y's dtype, zero elsewhere; the mask drawn
    from ``generator`` (on its device).  On a mesh each device takes its
    block of the mask the whole batch draws (``spatial.rand``)."""
    keep = 1.0 - rate
    mask = spatial.rand(y, generator) < keep
    return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))


class DeepLabV3Plus(PreparedModule):
    """(N, H, W, 3) normalized patches -> (N, H, W, num_classes) f32 softmax."""

    def __init__(self, num_classes: int = 2, dtype=torch.bfloat16,
                 aspp_pool_window: int = 0, s2d_stem: int = 0,
                 quantized=False):
        super().__init__(dtype, quantized)
        self.aspp_pool_window = int(aspp_pool_window)
        add = self.add_module

        def conv_bn(name, cin, cout, k=1, eps=1e-3):
            add(name, Conv(k, k, cin, cout, use_bias=False))
            add(f"{name}_BN", BatchNorm(cout, eps))

        def sep(prefix, cin, cout, eps=1e-3):
            add(f"{prefix}_depthwise", Conv(3, 3, 1, cin, use_bias=False))
            add(f"{prefix}_depthwise_BN", BatchNorm(cin, eps))
            conv_bn(f"{prefix}_pointwise", cin, cout, eps=eps)

        def block(prefix, cin, depths, skip_type):
            for i, d in enumerate(depths):
                sep(f"{prefix}_separable_conv{i + 1}",
                    cin if i == 0 else depths[i - 1], d)
            if skip_type == "conv":
                conv_bn(f"{prefix}_shortcut", cin, depths[-1])

        conv_bn("entry_flow_conv1_1", 3, 32, k=3)
        conv_bn("entry_flow_conv1_2", 32, 64, k=3)
        block("entry_flow_block1", 64, (128, 128, 128), "conv")
        block("entry_flow_block2", 128, (256, 256, 256), "conv")
        block("entry_flow_block3", 256, (728, 728, 728), "conv")
        for i in range(16):
            block(f"middle_flow_unit_{i + 1}", 728, (728, 728, 728), "sum")
        block("exit_flow_block1", 728, (728, 1024, 1024), "conv")
        block("exit_flow_block2", 1024, (1536, 1536, 2048), "none")
        conv_bn("image_pooling", 2048, 256, eps=1e-5)
        conv_bn("aspp0", 2048, 256, eps=1e-5)
        for i in (1, 2, 3):
            sep(f"aspp{i}", 2048, 256, eps=1e-5)
        conv_bn("concat_projection", 1280, 256, eps=1e-5)
        conv_bn("feature_projection0", 256, 48, eps=1e-5)
        sep("decoder_conv0", 304, 256, eps=1e-5)
        sep("decoder_conv1", 256, 256, eps=1e-5)
        add("custom_logits_semantic", Conv(1, 1, 256, num_classes))

    def _kernel(self, name):
        conv = getattr(self, name)
        return self._operands(name, (conv.kernel,),
                              lambda: torch_kernel(conv.kernel, self.dtype))

    def _bn(self, y, name, relu):
        return getattr(self, f"{name}_BN")(y, relu=relu)

    def _conv1x1(self, y, name, stride=1):
        """A 1x1 conv (VALID: at stride 2 it takes every other pixel)."""
        if self._quantizes(name):
            return self._qconv(y, name, stride=stride, same=False)
        return conv1x1(spatial.subsample(y, stride), getattr(self, name))

    def _conv3x3(self, y, name, stride=1):
        """A 3x3 conv with flax SAME padding (asymmetric at stride 2)."""
        if self._quantizes(name):
            return self._qconv(y, name, stride=stride)
        w = self._kernel(name)
        if stride == 1:
            y = spatial.conv2d(y, w, padding=1)
        else:
            y = spatial.conv2d(same_pad(y, 3, 3, stride), w, stride=stride)
        return channels.gather(y, getattr(self, name).kernel)

    def _sep_conv_bn(self, y, prefix, stride=1, rate=1,
                     depth_activation=False):
        if not depth_activation:
            y = torch.relu(y)
        # ``rate`` on each side: dilated SAME at stride 1, and at stride 2
        # (rate 1 at output stride 16) the reference's (1, 1) before VALID
        name = f"{prefix}_depthwise"
        kernel, w = getattr(self, name).kernel, self._kernel(name)
        y = spatial.conv2d(channels.mine(y, kernel), w, stride=stride,
                           padding=rate, dilation=rate, groups=w.shape[0])
        y = channels.gather(y, kernel)
        y = self._bn(y, name, depth_activation)
        name = f"{prefix}_pointwise"
        return self._bn(self._conv1x1(y, name), name, depth_activation)

    def _block(self, y, prefix, skip_type, stride, rate=1,
               depth_activation=False):
        """An Xception block -> (output, the second separable conv's
        output)."""
        residual, skip = y, None
        for i in range(3):
            residual = self._sep_conv_bn(
                residual, f"{prefix}_separable_conv{i + 1}",
                stride=stride if i == 2 else 1, rate=rate,
                depth_activation=depth_activation)
            if i == 1:
                skip = residual
        if skip_type == "conv":
            name = f"{prefix}_shortcut"
            shortcut = self._conv1x1(y, name, stride)
            return residual + self._bn(shortcut, name, False), skip
        if skip_type == "sum":
            return residual + y, skip
        return residual, skip

    def _conv1x1_bn_relu(self, y, name):
        return self._bn(self._conv1x1(y, name), name, True)

    def _image_pooling(self, y):
        """The ASPP's image-pooling branch at the features' size."""
        n, fh, fw_, c = spatial.shape(y)  # global: the check reads fh
        win = self.aspp_pool_window
        if win:
            fw = win // OUTPUT_STRIDE
            if fh % fw or fw_ % fw:
                raise ValueError(
                    f"aspp_pool_window {win} must divide the input size "
                    f"(features {fh}x{fw_}, window {fw})")
            b4 = spatial.avg_pool2d(y, fw, stride=fw)
        else:
            b4 = spatial.global_mean(y)  # the same on every strip
        b4 = self._conv1x1_bn_relu(b4, "image_pooling")
        if win:
            return spatial.repeat_interleave(b4, fw)
        return resize_bilinear_align_corners(b4, (fh, fw_), replicated=True)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        """``generator``: the dropout mask's source in train mode."""
        if self.training and DROPOUT_RATE and generator is None:
            raise ValueError("DeepLabV3Plus: a train-mode forward draws its "
                             "dropout mask from a torch.Generator; pass "
                             "generator=")
        dt = self.dtype
        x = x.to(dt)
        _, h, w, _ = spatial.shape(x)
        y = self._bn(self._conv3x3(x, "entry_flow_conv1_1", stride=2),
                     "entry_flow_conv1_1", True)
        y = self._bn(self._conv3x3(y, "entry_flow_conv1_2"),
                     "entry_flow_conv1_2", True)
        y, _ = self._block(y, "entry_flow_block1", "conv", 2)
        y, skip1 = self._block(y, "entry_flow_block2", "conv", 2)
        y, _ = self._block(y, "entry_flow_block3", "conv", 2)
        for i in range(16):
            y, _ = self._block(y, f"middle_flow_unit_{i + 1}", "sum", 1)
        y, _ = self._block(y, "exit_flow_block1", "conv", 1)
        y, _ = self._block(y, "exit_flow_block2", "none", 1, rate=2,
                           depth_activation=True)

        # ASPP
        _, fh, fw, _ = spatial.shape(y)
        branches = [self._image_pooling(y),
                    self._conv1x1_bn_relu(y, "aspp0")]
        for i, rate in enumerate(ATROUS_RATES):
            branches.append(self._sep_conv_bn(y, f"aspp{i + 1}", rate=rate,
                                              depth_activation=True))
        y = self._conv1x1_bn_relu(torch.cat(branches, dim=-1),
                                  "concat_projection")
        if self.training and DROPOUT_RATE:
            y = dropout(y, DROPOUT_RATE, generator)

        # decoder
        up = OUTPUT_STRIDE // 4
        y = resize_bilinear_align_corners(y, (fh * up, fw * up))
        dec_skip = self._conv1x1_bn_relu(skip1, "feature_projection0")
        y = torch.cat([y, dec_skip.to(dt)], dim=-1)
        y = self._sep_conv_bn(y, "decoder_conv0", depth_activation=True)
        y = self._sep_conv_bn(y, "decoder_conv1", depth_activation=True)
        y = conv1x1(y, self.custom_logits_semantic)
        y = resize_bilinear_align_corners(y, (h, w))
        return torch.softmax(y.float(), dim=-1)
