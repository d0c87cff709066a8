"""The CRF's truncated-window bilateral message: the Hopper kernel's wrapper.

``bilateral_message(q, image, sigma_xy, sigma_rgb, radius)`` gives, for each
pixel, the normalised sum over the (2r+1)^2 - 1 shifts of
``exp(-|s|^2 / 2 sigma_xy^2 - |dI|^2 / 2 sigma_rgb^2) * q[p + s]``, with
out-of-image neighbours weighted 0.  Its plain PyTorch version is
``ops/crf.py::_bilateral_message`` (the roll-and-mask loop of the JAX
reference), which the CPU tests and ``chip_smoke.py`` compare against.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/bilateral.py``
(``bilateral_message_pallas``, two labels only) with ``csrc/bilateral.cu``:
a shared-memory halo tile per block, K output rows per thread fed from
registers, one ``ex2`` per (pixel, shift) pair, bound by instruction issue
(see the source).  Any number of labels: the wrapper launches once per chunk
of up to four.

The host side of the kernel lives here: ``kernel_constants`` folds the two
sigmas and log2(e) into the kernel's two constants, and ``plan_bilateral``
chooses the tile from the radius and the label count.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.  ``bilateral_message.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

#: labels one launch handles (the kernel's register accumulators)
MAX_LABELS = 4
#: block tile width: one warp, one column per lane (csrc/bilateral.cu)
TW = 32
#: the compiled tiles, (K output rows per thread, rows of warps), tallest
#: first; and the radii compiled unrolled, with the tiles each is built for
TILES = ((4, 8), (2, 8), (1, 8))
SPECIALISED = {10: ((4, 8), (2, 8)), 20: ((4, 8), (2, 8))}
SMEM_ONE_BLOCK = 232_448  # dynamic shared memory one block may take
SMEM_TWO_BLOCKS = 115_712  # ... and leave room for a second on the SM
#: the card's streaming multiprocessors (H100 SXM)
SMS = 132
LOG2E = 1.0 / math.log(2.0)

#: tile mode refines two supertiles at once, one per flusher thread
_COUNT_LOCK = threading.Lock()


class BilateralPlan(NamedTuple):
    """How one launch of up to ``MAX_LABELS`` labels runs (a pure function of
    its shape)."""
    k: int        # output rows per thread
    warps: int    # rows of warps per block
    spec: int     # the radius the kernel unrolls, or 0 (run-time radius)
    smem: int     # dynamic shared memory per block, bytes
    blocks: int   # blocks in the grid

    @property
    def th(self) -> int:
        return self.k * self.warps

    def as_c(self):
        """The host int[3] the C entry point takes."""
        return (ctypes.c_int * 3)(self.k, self.warps, self.spec)


def halo_bytes(th: int, n_labels: int, r: int) -> int:
    """The halo tile of a 32 x th block: a float4 (r, g, b, q) per cell and
    the other labels' planes."""
    return (TW + 2 * r) * (th + 2 * r) * 4 * (3 + n_labels)


def plan_bilateral(h: int, w: int, n_labels: int, r: int) -> BilateralPlan:
    """The launch plan of one launch over an (h, w) grid with
    ``min(n_labels, MAX_LABELS)`` labels at radius ``r``.

    Among the tiles of ``TILES`` with K > 1 whose halo leaves room for two
    blocks per SM (else for one), the tallest whose grid gives every SM a
    block, else the shortest; K = 1 only where no taller tile fits.  The
    unrolled kernel where ``r`` is compiled for that tile.  Raises
    ``ValueError`` where no tile's halo fits.
    """
    nl = min(int(n_labels), MAX_LABELS)
    if nl < 1 or r < 0 or h < 1 or w < 1:
        raise ValueError(f"bilateral plan: bad shape h={h} w={w} "
                         f"labels={n_labels} r={r}")

    def blocks(tile):
        return -(-w // TW) * -(-h // (tile[0] * tile[1]))

    for budget in (SMEM_TWO_BLOCKS, SMEM_ONE_BLOCK):
        fits = [t for t in TILES if halo_bytes(t[0] * t[1], nl, r) <= budget]
        if fits:
            break
    else:
        raise ValueError(f"bilateral plan: the halo at r={r} with {nl} "
                         f"labels takes {halo_bytes(TILES[-1][0] * TILES[-1][1], nl, r)}"
                         f" bytes, more than {SMEM_ONE_BLOCK}")
    # K = 1 (no neighbour load shared by two outputs) only where nothing
    # taller fits
    fits = [t for t in fits if t[0] > 1] or fits
    k, warps = next((t for t in fits if blocks(t) >= SMS), fits[-1])
    if -(-h // (k * warps)) > 65535:
        raise ValueError(f"bilateral plan: {h} rows need more than 65535 "
                         f"blocks of {k * warps}")
    spec = r if (k, warps) in SPECIALISED.get(r, ()) else 0
    return BilateralPlan(k, warps, spec, halo_bytes(k * warps, nl, r),
                         blocks((k, warps)))


def kernel_constants(sigma_xy: float, sigma_rgb: float):
    """(a, cs), rounded to f32, of the kernel's exponent in base 2: a
    weight is ``2 ** (-a |s|^2 - |cs dI|^2)``, with ``a = log2(e) / 2
    sigma_xy^2`` and ``cs = sqrt(log2(e) / 2 sigma_rgb^2)``; the kernel
    stages the colours times ``cs``.  ``cs`` stays above 0 (at least 1e-30),
    so an out-of-image cell's infinite colour gives weight 0."""
    a = LOG2E * 0.5 / (float(sigma_xy) * float(sigma_xy))
    cs = max(math.sqrt(LOG2E * 0.5) / float(sigma_rgb), 1e-30)
    f32 = ctypes.c_float
    return f32(a).value, f32(cs).value


def bilateral_message(q, image, sigma_xy: float, sigma_rgb: float,
                      radius: int):
    """q: (H, W, L) float32; image: (H, W, 3) float32 -> (H, W, L) float32."""
    if q.device.type == "cpu":
        from .crf import _bilateral_message

        return _bilateral_message(q, image, sigma_xy, sigma_rgb, radius)
    if q.device.type != "cuda":
        raise ValueError(f"bilateral_message: unsupported device {q.device}")
    if q.dtype != torch.float32 or image.dtype != torch.float32:
        raise TypeError(f"bilateral_message: q and image must be float32, got "
                        f"{q.dtype} and {image.dtype}")
    if q.dim() != 3 or tuple(image.shape) != (*q.shape[:2], 3):
        raise ValueError(f"bilateral_message: q {tuple(q.shape)} must be "
                         f"(H, W, L) and image {tuple(image.shape)} (H, W, 3)")
    if image.device != q.device:
        raise ValueError("bilateral_message: q and image on different devices")
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"bilateral_message: radius {radius} < 0")
    if not (sigma_xy > 0 and sigma_rgb > 0):
        raise ValueError(f"bilateral_message: sigmas {sigma_xy}, {sigma_rgb} "
                         f"must be > 0")
    from .. import _build

    lib = _build.load("bilateral")
    q = q.contiguous()
    image = image.contiguous()
    h, w, n_labels = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    a, cs = kernel_constants(sigma_xy, sigma_rgb)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        for l0 in range(0, n_labels, MAX_LABELS):
            nl = min(MAX_LABELS, n_labels - l0)
            plan = plan_bilateral(h, w, nl, radius)
            rc = lib.dpai_bilateral_message(
                q.data_ptr(), image.data_ptr(), out.data_ptr(), h, w,
                n_labels, l0, nl, radius, a, cs, plan.as_c(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"bilateral_message: kernel launch failed with CUDA error "
                    f"{rc} (H={h} W={w} L={n_labels} r={radius} plan {plan})")
            with _COUNT_LOCK:
                bilateral_message.launches += 1
    return out


bilateral_message.launches = 0
