"""Mean-field dense-CRF refinement on PyTorch, in float32 throughout.

Port of ``digipathai_tpu/ops/crf.py``: a unary from the softmax (clip 1e-5),
an exact position-only Gaussian pairwise term (separable depthwise
convolutions, truncated at 3 sigma, with the masked degree) and the
ConvCRF-style truncated-window bilateral term evaluated on a grid
downsampled by cell means, entering the logits with Potts weights.  The
bilateral message runs on the hand-written CUDA kernel for a CUDA tensor
(``ops/bilateral.py``) and on its plain version, ``_bilateral_message``,
for a CPU tensor.

Host entry points take numpy and a ``device``; the mean-field functions
take tensors on any one device.  The iterations are a Python loop: PyTorch
frees each iteration's temporaries as it goes.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from .bilateral import bilateral_message

#: pad colour for bucket-padded tiles: far enough from any real colour that
#: every bilateral weight involving a pad (or pad-straddling downsample
#: cell) is exactly 0.0 in float32, even diluted into a ds^2 cell mean
_PAD_COLOR = 1.0e6


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k.astype(np.float32)


#: the TF32 switch is process-wide; the server runs each segmentation in a
#: thread of its own, so two CRF runs must not restore it under each other
_TF32_LOCK = threading.Lock()


@contextmanager
def _no_tf32(x):
    """cuDNN convolutions in full float32 (it allows TF32 by default).  The
    lock is held while the block launches its convolutions: cuDNN picks its
    algorithm, and so reads the switch, on the host at the call."""
    if x.device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def _blur2d(x, sigma: float, radius: int):
    """Separable (unnormalized) Gaussian filtering of (H, W, C), zero pad."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(x.device)
    c = x.shape[-1]
    xb = x.permute(2, 0, 1)[None]  # (1, C, H, W)
    with _no_tf32(x):
        xb = F.conv2d(xb, k.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                      padding=(radius, 0), groups=c)
        xb = F.conv2d(xb, k.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                      padding=(0, radius), groups=c)
    return xb[0].permute(1, 2, 0)


def _gaussian_message(q, sigma: float, mask=None):
    """Exact symmetric-normalized Gaussian pairwise message (self excluded).

    With ``mask`` (H, W, 1 float, 1 = valid) the degree counts valid pixels
    only (``q`` must already be zero outside the mask)."""
    radius = int(3 * sigma)
    ones = mask if mask is not None else torch.ones(
        q.shape[:2] + (1,), dtype=q.dtype, device=q.device)
    d = _blur2d(ones, sigma, radius)  # degree (includes self weight 1)
    inv_sqrt_d = 1.0 / torch.sqrt(torch.clamp(d, min=1e-12))
    m = _blur2d(q * inv_sqrt_d, sigma, radius) * inv_sqrt_d
    # remove the self term: k(i,i)=1 -> contribution Q_i / d_i
    return m - q / torch.clamp(d, min=1e-12)


def _bilateral_message(q, image, sigma_xy: float, sigma_rgb: float,
                       radius: int):
    """Truncated-window bilateral message with per-pixel normalization: the
    plain version of the kernel, as the JAX reference computes it."""
    h, w, _ = q.shape
    img = image.to(torch.float32)
    num = torch.zeros_like(q)
    den = torch.zeros(q.shape[:2] + (1,), dtype=q.dtype, device=q.device)
    inv2_xy = 0.5 / (sigma_xy * sigma_xy)
    inv2_c = 0.5 / (sigma_rgb * sigma_rgb)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            # shifts at or beyond the grid extent have no valid pixel pairs;
            # skipping them also keeps the wrap masks below from wrapping
            y0m, y1m = max(0, dy), h + min(0, dy)
            x0m, x1m = max(0, dx), w + min(0, dx)
            if y1m <= y0m or x1m <= x0m:
                continue
            sq = torch.roll(q, (dy, dx), (0, 1))
            si = torch.roll(img, (dy, dx), (0, 1))
            wgt = torch.exp(
                -(dy * dy + dx * dx) * inv2_xy
                - ((img - si) ** 2).sum(-1, keepdim=True) * inv2_c)
            # mask out the wrap-around rows/cols of the roll
            ys = torch.zeros((h, 1, 1), dtype=q.dtype, device=q.device)
            ys[y0m:y1m] = 1.0
            xs = torch.zeros((1, w, 1), dtype=q.dtype, device=q.device)
            xs[:, x0m:x1m] = 1.0
            wgt = wgt * ys * xs
            num = num + wgt * sq
            den = den + wgt
    return num / torch.clamp(den, min=1e-12)


def _bilateral_message_dispatch(q, image, sigma_xy, sigma_rgb, radius):
    """A CPU tensor takes the plain version, a CUDA tensor the kernel, any
    other device raises (``bilateral_message`` decides)."""
    return bilateral_message(q, image, float(sigma_xy), float(sigma_rgb),
                             int(radius))


def production_bilateral_message(q, image_u8, bil_sigma_xy=50.0,
                                 bil_sigma_rgb=20.0, bil_downsample=4,
                                 bil_radius=10, valid_hw=None):
    """The engine's bilateral message at full resolution: the truncated
    window at a grid downsampled by cell means, repeated back and
    edge-padded.  ``q`` is (H, W, L) float32.

    With ``valid_hw`` (bucket-padded tiles), rows and columns past the last
    fully valid cell read that cell's message, as the unpadded computation's
    crop and edge pad would."""
    h, w, n_labels = q.shape
    # clamp: tiny edge chunks would yield an empty downsampled grid
    ds = max(1, min(bil_downsample, h, w))
    hd, wd = h // ds, w // ds
    img_small = image_u8[:hd * ds, :wd * ds].to(torch.float32).reshape(
        hd, ds, wd, ds, 3).mean((1, 3))
    q_small = q[:hd * ds, :wd * ds].reshape(hd, ds, wd, ds, n_labels).mean(
        (1, 3))
    m_small = _bilateral_message_dispatch(
        q_small, img_small, bil_sigma_xy / ds, bil_sigma_rgb, bil_radius)
    rows = torch.arange(h, device=q.device)
    cols = torch.arange(w, device=q.device)
    if valid_hw is not None:
        rows = rows.clamp(max=max((int(valid_hw[0]) // ds) * ds - 1, 0))
        cols = cols.clamp(max=max((int(valid_hw[1]) // ds) * ds - 1, 0))
    # repeat by ds, then the edge pad: one gather
    rows = (rows // ds).clamp(max=hd - 1)
    cols = (cols // ds).clamp(max=wd - 1)
    return m_small[rows[:, None], cols[None, :]]


def mean_field_crf(image_u8, probs_fg, n_iters: int = 10,
                   pos_sigma: float = 10.0, bil_sigma_xy: float = 50.0,
                   bil_sigma_rgb: float = 20.0, bil_downsample: int = 4,
                   bil_radius: int = 10, compat_gaussian: float = 3.0,
                   compat_bilateral: float = 10.0, valid_hw=None):
    """Refine a foreground-probability map given its RGB image.

    Args:
      image_u8: (H, W, 3) uint8 tensor.
      probs_fg: (H, W) float32 tensor in [0, 1], on the same device.
      valid_hw: optional (vh, vw) valid extents of a bucket-padded tile:
        pixels at row >= vh or col >= vw are absent (masked Gaussian degree,
        exactly-zero bilateral weights through ``_PAD_COLOR``).
    Returns the refined foreground probability (H, W) float32 (the pad
    region's contents are unspecified when ``valid_hw`` is given).
    """
    mask = None
    image = image_u8
    if valid_hw is not None:
        h, w = probs_fg.shape
        mask = torch.zeros((h, w, 1), dtype=torch.float32,
                           device=probs_fg.device)
        mask[:int(valid_hw[0]), :int(valid_hw[1])] = 1.0
        image = torch.where(mask > 0, image_u8.to(torch.float32), _PAD_COLOR)
        probs_fg = probs_fg * mask[..., 0]
    p2 = torch.stack([1.0 - probs_fg, probs_fg], -1)
    q = p2 * mask if mask is not None else p2
    u = -torch.log(torch.clamp(p2, 1e-5, 1.0))  # unary_from_softmax w/ clip
    for _ in range(n_iters):
        m_gauss = _gaussian_message(q, pos_sigma, mask)
        m_bil = production_bilateral_message(
            q, image, bil_sigma_xy, bil_sigma_rgb, bil_downsample,
            bil_radius, valid_hw=valid_hw)
        logits = -u + compat_gaussian * m_gauss + compat_bilateral * m_bil
        q = torch.softmax(logits, -1)
        if mask is not None:
            q = q * mask
    return q[..., 1]


def _mean_field_from_unary(image_u8, unary, *, n_labels: int, n_iters: int,
                           enable_color: bool, pos_sigma: float,
                           compat_gaussian: float, bil_sigma_xy: float,
                           bil_sigma_rgb: float, bil_downsample: int,
                           bil_radius: int, compat_bilateral: float):
    """Multi-label mean-field iterations from an explicit unary (H, W, L)."""
    q = torch.softmax(-unary, -1)  # pydensecrf startInference
    for _ in range(n_iters):
        m = compat_gaussian * _gaussian_message(q, pos_sigma)
        if enable_color:
            m = m + compat_bilateral * production_bilateral_message(
                q, image_u8, bil_sigma_xy, bil_sigma_rgb, bil_downsample,
                bil_radius)
        q = torch.softmax(-unary + m, -1)
    return q


def do_crf(im, mask, n_labels: int, enable_color: bool = False,
           zero_unsure: bool = True, n_iters: int = 5,
           faithful_shift: bool = False, device="cuda") -> np.ndarray:
    """Label-input dense-CRF refinement (``digipathai_tpu/ops/crf.py::do_crf``).

    A unary from the label map (``unary_from_labels``, gt_prob 0.7), a
    position-only Gaussian term (sxy 3, compat 3), an optional colour
    bilateral term (sxy 80, srgb 13, compat 10, downsample 4, radius 20)
    and ``n_iters`` mean-field iterations; the argmax maps back to the
    original label values.  ``zero_unsure`` treats the smallest label as
    uncertain (a uniform unary); ``faithful_shift=True`` reproduces the
    reference's off-by-one label mapping.  Runs on ``device``.
    """
    mask = np.asarray(mask)
    colors, labels = np.unique(mask, return_inverse=True)
    labels = labels.reshape(mask.shape).astype(np.int32)

    # unary_from_labels (pydensecrf.utils) semantics, gt_prob = 0.7
    gt_prob = 0.7
    p_energy = -np.log(gt_prob)
    n_energy = (-np.log((1.0 - gt_prob) / (n_labels - 1))
                if n_labels > 1 else p_energy)
    idx = labels - 1 if zero_unsure else labels
    one_hot = idx[..., None] == np.arange(n_labels)  # out of range: all off
    unary = np.where(one_hot, p_energy, n_energy).astype(np.float32)
    if zero_unsure:
        unary = np.where((labels == 0)[..., None],
                         np.float32(-np.log(1.0 / n_labels)), unary)

    dev = torch.device(device)
    q = _mean_field_from_unary(
        torch.from_numpy(np.array(im, np.uint8)).to(dev),
        torch.from_numpy(unary).to(dev), n_labels=n_labels,
        n_iters=n_iters, enable_color=bool(enable_color),
        pos_sigma=3.0, compat_gaussian=3.0, bil_sigma_xy=80.0,
        bil_sigma_rgb=13.0, bil_downsample=4, bil_radius=20,
        compat_bilateral=10.0)
    map_idx = torch.argmax(q, -1).cpu().numpy()
    if zero_unsure and not faithful_shift:
        map_idx = map_idx + 1  # class c <-> inverse label c + 1
    # indices beyond len(colors)-1 (n_labels > distinct values) clamp
    return colors[np.minimum(map_idx, len(colors) - 1)]


def crf_buckets(supertile: int):
    """The 3 padded-tile sizes ``refine_tile`` pads to: every tile shape
    pads up to one of these, as in the JAX engine."""
    return sorted({-(-supertile // 4), -(-supertile // 2), supertile})


def refine_tile(img_u8, probs, supertile: int, n_iters: int = 10,
                device="cuda", **kw) -> np.ndarray:
    """Bucket-padded single-tile CRF on ``device``: pads ``img_u8`` (h, w, 3)
    and ``probs`` (h, w) up to the smallest bucket and runs the masked
    ``mean_field_crf`` with ``valid_hw``.  Returns the refined (h, w)
    float32 numpy map."""
    h, w = probs.shape
    ds = kw.get("bil_downsample", 4)
    dev = torch.device(device)

    def run(img, p, **extra):
        out = mean_field_crf(
            torch.from_numpy(np.array(img, np.uint8)).to(dev),
            torch.from_numpy(np.array(p, np.float32)).to(dev),
            n_iters=n_iters, **extra, **kw)
        return out.cpu().numpy()

    if h < ds or w < ds:
        # sliver tiles (an extent smaller than one downsample cell): the
        # masked bucket form would carry the sentinel in its only cell and
        # zero the whole bilateral term, while the unpadded form clamps the
        # downsample to the tile
        return run(img_u8, probs)
    buckets = crf_buckets(supertile)
    bh = next(b for b in buckets if b >= h)
    bw = next(b for b in buckets if b >= w)
    pi = np.zeros((bh, bw, 3), np.uint8)
    pi[:h, :w] = img_u8
    pp = np.zeros((bh, bw), np.float32)
    pp[:h, :w] = probs
    return run(pi, pp, valid_hw=(h, w))[:h, :w]


def slide_tile_index(oy: int, ox: int, X: int, supertile: int) -> int:
    """Row-major supertile index of the tile at map offset ``(oy, ox)``: the
    CRF resume bookkeeping's one numbering."""
    return (oy // supertile) * (-(-X // supertile)) + (ox // supertile)


def refine_slide_crf(slide, mean_map, supertile: int = 4096,
                     n_iters: int = 10, done=None, on_tile=None,
                     device="cuda", **kw) -> None:
    """Apply mean-field CRF per supertile, updating ``mean_map`` in place.

    ``mean_map`` is the finalized (Y, X) float32 probability memmap; the
    matching RGB pixels are re-read from the slide per supertile.  Tiles
    whose index is in ``done`` are skipped, and so are tiles with no
    probability above 0; ``on_tile(ti, (y0, y1, x0, x1), refined)``, when
    given, does the write-back, otherwise the tile is assigned directly.
    """
    Y, X = mean_map.shape
    for y0 in range(0, Y, supertile):
        for x0 in range(0, X, supertile):
            ti = slide_tile_index(y0, x0, X, supertile)
            if done is not None and ti in done:
                continue
            y1, x1 = min(y0 + supertile, Y), min(x0 + supertile, X)
            probs = np.asarray(mean_map[y0:y1, x0:x1], np.float32)
            if probs.max() <= 0:
                continue  # nothing to refine in glass-only regions
            img = slide.read_region((x0, y0), 0, (x1 - x0, y1 - y0))
            refined = refine_tile(np.asarray(img), probs, supertile,
                                  n_iters=n_iters, device=device, **kw)
            if on_tile is not None:
                on_tile(ti, (y0, y1, x0, x1), refined)
            else:
                mean_map[y0:y1, x0:x1] = refined
    if hasattr(mean_map, "flush"):
        mean_map.flush()
