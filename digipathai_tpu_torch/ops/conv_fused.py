"""Fused 3x3 conv + bias + BN-affine + relu: the Hopper kernel and its plain twin.

``fused_conv3x3`` computes ``relu((conv3x3_same(h, k) + bias) * mul + add)``
on NHWC tensors, where ``h = relu(x * pre_mul + pre_add)`` when a
pre-affine is given and ``h = x`` otherwise; the SAME halo is zero after the
pre-activation.  It is both the DenseNet dense layer's BN -> relu -> 3x3 conv
and the U-Net decoder's conv + bias + BN + relu block.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/conv_fused.py``
(``fused_conv3x3``, N=1 only) with ``csrc/conv_fused.cu``: an implicit-GEMM
conv (``csrc/conv3x3_igemm.cuh``; bf16 on ``wgmma`` with f32 accumulation)
that takes any N >= 1 and any C and F.  Each block loads its output tile's
input window once per channel chunk, pre-activated on the way in, and runs
the 9 taps as shifted views of it; the affine/relu is the epilogue.

The host side of the kernel lives here:

- ``plan_conv`` chooses the tile, the K chunk, the N tile, the split of K
  and the pipeline depth from the shape alone;
- ``prepare`` lays out one conv's operands for the kernel (the kernel packed
  for its plan, the folded affine, the pre-affine in the activation type).
  The model prepares each conv once and hands the ``ConvOperands`` to the
  wrapper in place of ``k``; raw parameters are prepared on every call.

Dispatch: a CPU tensor runs ``fused_conv3x3_plain`` (on the raw parameters
of ``ConvOperands``); a CUDA tensor launches the kernel or raises.  ``fused_conv3x3.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_DTYPES = (torch.float32, torch.bfloat16)

#: the card's streaming multiprocessors (H100 SXM): split K below two waves
SMS = 132
#: the compiled wgmma N tiles: BN -> (K chunk, row blocks per warpgroup).
#: A block of two warpgroups computes 128 * row blocks positions; the K
#: chunk and row blocks are the faster of those measured on an H100 (PERF.md)
TILES = {32: (16, 2), 64: (16, 4), 96: (32, 2), 128: (16, 2), 160: (16, 2)}
SMEM_ONE_BLOCK = 232_448  # dynamic shared memory one block may take
SMEM_TWO_BLOCKS = 115_712  # ... and leave room for a second on the SM
MAXV = 6  # window vectors per thread and chunk (csrc/conv3x3_igemm.cuh)
THREADS = 256


class ConvPlan(NamedTuple):
    """How one conv launches (a pure function of its shape).  ``vector``
    False: the scalar FMA path, and the other fields are 0 / 1."""
    vector: bool
    bn: int        # N tile (wgmma width)
    bk: int        # channels per K chunk
    tw: int        # tile columns; tile rows are tile_m // tw
    splits: int    # K split across blocks, reduced in a fixed order
    stages: int    # ring depth in shared memory
    tiles: int     # output tiles (positions x N tiles x parities)
    chunks: int    # K chunks per tap
    mi: int        # wgmma row blocks (64 positions) per warpgroup

    @property
    def tile_m(self) -> int:
        return 128 * self.mi

    @property
    def th(self) -> int:
        return self.tile_m // self.tw if self.vector else 0

    def k_ranges(self):
        """The chunk range [begin, end) of each split, as the kernel takes
        them."""
        return [(s * self.chunks // self.splits,
                 (s + 1) * self.chunks // self.splits)
                for s in range(self.splits)]

    def as_c(self):
        """The host int[6] the C entry points take."""
        return (ctypes.c_int * 6)(self.bn, self.bk, self.tw, self.splits,
                                  self.stages, self.mi)


def is_vector(dtype, f: int, *cs: int) -> bool:
    """The wgmma path takes bf16 with every channel count a multiple of 8;
    everything else (f32, the ragged rows) takes the scalar path."""
    return dtype == torch.bfloat16 and f % 8 == 0 and all(c % 8 == 0
                                                          for c in cs)


def tile_widths(f: int):
    """(bn, bk, mi): the N tile that pads F least (the wider on a tie),
    its K chunk and its wgmma row blocks per warpgroup (``TILES``)."""
    bn = min(TILES, key=lambda b: (-(-f // b) * b, -b))
    return (bn, *TILES[bn])


def stage_bytes(taps: int, tm: int, tw: int, bk: int, bn: int) -> int:
    """One ring stage: the input window, then the kernel slab."""
    window = (tm // tw + taps - 1) * (tw + taps - 1) * bk * 2
    return (window + 127) // 128 * 128 + taps * taps * bk * bn * 2


def plan_conv(n: int, hi: int, wi: int, c0: int, c1: int, f: int, dtype,
              taps: int = 3) -> ConvPlan:
    """The launch plan of one conv over an (n, hi, wi) grid of positions.

    taps 3 is a 3x3 SAME conv; taps 2 the four 2x2 parity classes of a conv
    over a nearest 2x upsample (``ops/stage_fused.py``).  A tile is 128
    positions per row block (``TILES``), 16 columns wide, or 8 where that
    pads the grid less; K is split where the tiles fill fewer than two waves
    of ``SMS`` blocks; the ring takes 4 or 3 stages, within the shared
    memory that leaves room for two blocks per SM where the registers do
    (at most 64 accumulators per thread).
    """
    parities = 4 if taps == 2 else 1
    if not is_vector(dtype, f, c0, c1):
        return ConvPlan(False, 0, 0, 0, 1, 0, 0, 0, 0)
    bn, bk, mi = tile_widths(f)
    tm = 128 * mi

    def area(tw):
        th = tm // tw
        return -(-hi // th) * th * -(-wi // tw) * tw

    tw = 16 if area(16) <= area(8) else 8
    th = tm // tw
    if (th + taps - 1) * (tw + taps - 1) * bk // 8 > MAXV * THREADS:
        raise ValueError(f"conv plan: the window of a {th}x{tw} tile takes "
                         f"more than {MAXV} vectors per thread")
    if n * hi * wi >= 2 ** 31:
        raise ValueError(f"conv plan: {n}x{hi}x{wi} positions overflow the "
                         f"kernel's 32-bit pixel index")
    chunks = -(-(c0 + c1) // bk)
    tiles = n * -(-hi // th) * -(-wi // tw) * -(-f // bn) * parities
    splits = 1 if tiles >= 2 * SMS else min(chunks, -(-2 * SMS // tiles))
    sb = stage_bytes(taps, tm, tw, bk, bn)
    # registers leave room for two blocks per SM up to 64 accumulators
    budgets = (SMEM_TWO_BLOCKS, SMEM_ONE_BLOCK) if mi * bn <= 128 else (
        SMEM_ONE_BLOCK,)
    for budget in budgets:
        stages = next((s for s in (4, 3)
                       if s * (sb + 8) + 2 * bn * 4 <= budget), 0)
        if stages:
            break
    if not stages:
        raise ValueError(f"conv plan: a 3-stage ring of {sb} bytes does not "
                         f"fit in shared memory (taps={taps} bn={bn})")
    return ConvPlan(True, bn, bk, tw, splits, stages, tiles, chunks, mi)


class ConvOperands(NamedTuple):
    """One conv's operands laid out for the kernel, on one device."""
    w: torch.Tensor                # packed for the plan, or (P, T, T, C, F)
    mul: torch.Tensor              # (F,) f32
    off: torch.Tensor              # (F,) f32: add + bias * mul
    pm: Optional[torch.Tensor]     # (C,) pre-affine, activation type
    pa: Optional[torch.Tensor]
    taps: int
    c0: int                        # channels from the first source
    c: int
    f: int
    dtype: torch.dtype
    raw: tuple                     # (k, bias, mul, add, pre_mul, pre_add)


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


def pack_kernel(w: torch.Tensor, bn: int, bk: int) -> torch.Tensor:
    """(P, T, T, C, F) -> the wgmma path's layout: for each parity, N tile
    and K chunk, the shared-memory image of its slab, [tap][8-channel
    group][n][8 channels], zero-padded to whole chunks and N tiles."""
    p, t, _, c, f = w.shape
    nc, nt = -(-c // bk), -(-f // bn)
    w = F.pad(w.reshape(p, t * t, c, f), (0, nt * bn - f, 0, nc * bk - c))
    w = w.reshape(p, t * t, nc, bk // 8, 8, nt, bn)
    return w.permute(0, 5, 2, 1, 3, 6, 4).contiguous()


def prepare(k, bias=None, mul=None, add=None, pre_mul=None, pre_add=None, *,
            dtype, device, c0=None) -> ConvOperands:
    """Lay out one conv's operands for the kernel.

    k: (3, 3, C, F), or (4, 2, 2, C, F) for the four folded parity kernels
    of a conv over a nearest 2x upsample; c0: the channels read from the
    first source (default C).  The kernel is cast to ``dtype`` once, after
    any folding, and packed for the vector path where the shape takes it.
    """
    taps = 2 if k.dim() == 5 else 3
    c, f = k.shape[-2], k.shape[-1]
    c0 = c if c0 is None else c0
    w = k.reshape(-1, taps, taps, c, f).to(device, dtype)
    if is_vector(dtype, f, c0, c - c0):
        w = pack_kernel(w, *tile_widths(f)[:2])
    mul_, off = _affine(f, bias, mul, add, device)
    pm, pa = _pre(c, pre_mul, pre_add, dtype, device)
    return ConvOperands(w.contiguous(), mul_, off, pm, pa, taps, c0, c, f,
                        dtype, (k, bias, mul, add, pre_mul, pre_add))


def scratch(plans, positions: int, f: int, device):
    """The split-K partials for the largest split among ``plans``, or
    None."""
    splits = max(p.splits for p in plans)
    if splits == 1:
        return None
    return torch.empty((splits, positions, f), dtype=torch.float32,
                       device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_conv3x3_plain(x, k, bias=None, mul=None, add=None, *, relu=True,
                        pre_mul=None, pre_add=None):
    """Plain PyTorch version: pre-activation, zero pad, ``F.conv2d``,
    affine, relu.  x: (N, H, W, C); k: (3, 3, C, F), or ``ConvOperands``
    (whose raw parameters it takes) -> (N, H, W, F) x.dtype."""
    if isinstance(k, ConvOperands):
        k, bias, mul, add, pre_mul, pre_add = k.raw
    dt = x.dtype
    pm, pa = _pre(x.shape[-1], pre_mul, pre_add, dt, x.device)
    h = x if pm is None else torch.relu(x * pm + pa)
    y = F.conv2d(h.permute(0, 3, 1, 2), k.to(x.device, dt).permute(3, 2, 0, 1),
                 padding=1)
    return epilogue_plain(y.permute(0, 2, 3, 1), k.shape[-1], bias, mul, add,
                          relu)


def epilogue_plain(y, f, bias, mul, add, relu):
    """``relu(y * mul + (add + bias * mul))`` in f32 on an NHWC conv output,
    rounded once to y.dtype."""
    mul_, off = _affine(f, bias, mul, add, y.device)
    z = y.float() * mul_ + off
    if relu:
        z = torch.relu(z)
    return z.to(y.dtype).contiguous()


def launch(x, ops: ConvOperands, *, relu, out, part=None, plan=None):
    """Launch the kernel on CUDA operands that are in place: x (N, H, W, C)
    contiguous, ``out`` (N, H, W, F), ``part`` the split-K scratch of
    ``plan`` (``plan_conv`` of this shape when None).  Counts the launch."""
    from .. import _build

    n, h, w, c = x.shape
    plan = plan or plan_conv(n, h, w, c, 0, ops.f, x.dtype)
    lib = _build.load("conv_fused")
    with torch.cuda.device(x.device):
        rc = lib.dpai_fused_conv3x3(
            x.data_ptr(), ops.w.data_ptr(), ops.mul.data_ptr(),
            ops.off.data_ptr(), _ptr(ops.pm), _ptr(ops.pa), out.data_ptr(),
            _ptr(part), n, h, w, c, ops.f, int(relu),
            int(x.dtype == torch.bfloat16), plan.as_c(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv3x3: kernel launch failed with CUDA "
                           f"error {rc} (N={n} H={h} W={w} C={c} F={ops.f} "
                           f"plan {plan})")
    _build.count_launch(fused_conv3x3)
    return out


def fused_conv3x3(x, k, bias=None, mul=None, add=None, *, relu=True,
                  pre_mul=None, pre_add=None):
    """``relu((conv3x3_same(h, k) + bias) * mul + add)``, NHWC.

    x: (N, H, W, C) float32 or bfloat16; k: (3, 3, C, F), or the
    ``ConvOperands`` that ``prepare`` made for x's device and dtype (then
    bias, mul, add, pre_mul and pre_add are None); bias/mul/add: (F,) or
    None; pre_mul/pre_add: (C,) or None.  Returns (N, H, W, F) in x.dtype.
    The conv accumulates in f32; in bf16 the pre-activation rounds after the
    multiply and after the add, as the plain version does.
    """
    prepared = isinstance(k, ConvOperands)
    if prepared and ((k.taps, k.c0, k.c, k.dtype, k.w.device) != (
            3, x.shape[-1], x.shape[-1], x.dtype, x.device) or any(
            v is not None for v in (bias, mul, add, pre_mul, pre_add))):
        raise ValueError(f"fused_conv3x3: operands prepared for taps="
                         f"{k.taps} C={k.c} {k.dtype} on {k.w.device} do not "
                         f"take x {tuple(x.shape)} {x.dtype} on {x.device}")
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
    if prepared:
        f = k.f
    else:
        if k.dim() != 4 or tuple(k.shape[:3]) != (3, 3, c):
            raise ValueError(f"fused_conv3x3: kernel shape {tuple(k.shape)} "
                             f"is not (3, 3, {c}, F)")
        f = k.shape[-1]
        for name, v, size in (("bias", bias, f), ("mul", mul, f),
                              ("add", add, f), ("pre_mul", pre_mul, c),
                              ("pre_add", pre_add, c)):
            if v is not None and tuple(v.shape) != (size,):
                raise ValueError(f"fused_conv3x3: {name} shape "
                                 f"{tuple(v.shape)} != ({size},)")
    from .. import _build

    _build.load("conv_fused")  # raises before any work if it cannot build
    out = torch.empty((n, h, w, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ops = k if prepared else prepare(k, bias, mul, add, pre_mul, pre_add,
                                     dtype=x.dtype, device=x.device)
    plan = plan_conv(n, h, w, c, 0, f, x.dtype)
    return launch(x, ops, relu=relu, out=out, plan=plan,
                  part=scratch([plan], n * h * w, f, x.device))


fused_conv3x3.launches = 0
