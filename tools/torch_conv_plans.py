#!/usr/bin/env python3
"""Time the port's conv kernel under other launch plans on one NVIDIA GPU.

    python3 tools/torch_conv_plans.py

For main-path conv shapes of the DenseNet121-U-Net (batch-32 patch forward,
4352^2 tile forward and its decoder stages as 3x3 convs), builds the kernels,
then times ``ops/conv_fused.py``'s kernel under each (row blocks per
warpgroup, K chunk) pair that ``csrc/conv3x3_igemm.cuh`` compiles for the
shape's N tile, with every other plan field chosen by ``plan_conv``.  Each
time is kernel-only: back-to-back launches in one CUDA graph
(``chip_smoke.graph_ms``), operands prepared beforehand; each output is held
to the plain version.  ``ops/conv_fused.py::TILES`` keeps the fastest pair.
Prints one line per (shape, pair) and the card's name and power limit.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from digipathai_tpu_torch.ops import conv_fused as cf  # noqa: E402

# (n, h, w, c, f, pre-affine), [(row blocks, K chunk)] compiled for its BN;
# BN 64's 512-position tile fits no 32-channel chunk
SHAPES = [
    ((32, 64, 64, 128, 32, True), [(2, 16), (2, 32)]),
    ((1, 1088, 1088, 128, 32, True), [(2, 16), (2, 32)]),
    ((32, 16, 16, 128, 32, True), [(2, 16), (2, 32)]),
    ((32, 256, 256, 64, 64, False), [(4, 16)]),
    ((32, 256, 256, 96, 64, False), [(4, 16)]),
    ((1, 4352, 4352, 64, 64, False), [(4, 16)]),
    ((32, 128, 128, 128, 96, False), [(2, 16), (2, 32)]),
    ((1, 2176, 2176, 160, 96, False), [(2, 16), (2, 32)]),
    ((32, 64, 64, 384, 128, False), [(2, 16)]),
    ((32, 16, 16, 1344, 320, False), [(2, 16)]),
]


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    state = {"smi": cs.smi_line()}
    cs.phase_build(state)
    tiles = dict(cf.TILES)
    for (n, h, w, c, f, pre), pairs in SHAPES:
        x, k, kw = cs.conv_inputs(n, h, w, c, f, pre, torch.bfloat16, seed=1)
        relu = kw.pop("relu", True)
        ref = cf.fused_conv3x3_plain(x, k, **kw, relu=relu)
        for mi, bk in pairs:
            bn = cf.tile_widths(f)[0]
            cf.TILES[bn] = (bk, mi)
            try:
                plan = cf.plan_conv(n, h, w, c, 0, f, torch.bfloat16)
                ops = cf.prepare(k, **kw, dtype=x.dtype, device=x.device)
            except ValueError as e:  # the ring does not fit
                print(f"[plans] {(n, h, w, c)}->{f} rows={mi} bk={bk}: {e}")
                continue
            finally:
                cf.TILES.update(tiles)
            out = torch.empty_like(ref)
            part = cf.scratch([plan], n * h * w, f, x.device)
            t = cs.graph_ms(lambda: cf.launch(x, ops, relu=relu, out=out,
                                              part=part, plan=plan))
            err, _ = cs.check(f"{(n, h, w, c, f)}", out, ref, cs.BF16_REL)
            print(f"[plans] {(n, h, w, c)}->{f} bn={bn} rows={mi} bk={bk}: "
                  f"{cs.plan_text(plan)}; kernel {t:.4f} ms, max|d| {err:.3e}"
                  f" | {state['smi']}", flush=True)
        del x, k, kw, ref
        torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
