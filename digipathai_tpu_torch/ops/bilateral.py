"""The CRF's truncated-window bilateral message: the Hopper kernel's wrapper.

``bilateral_message(q, image, sigma_xy, sigma_rgb, radius)`` gives, for each
pixel, the normalised sum over the (2r+1)^2 - 1 shifts of
``exp(-|s|^2 / 2 sigma_xy^2 - |dI|^2 / 2 sigma_rgb^2) * q[p + s]``, with
out-of-image neighbours weighted 0.  Its plain PyTorch version is
``ops/crf.py::_bilateral_message`` (the roll-and-mask loop of the JAX
reference), which the CPU tests and ``chip_smoke.py`` compare against.

It replaces the TPU kernel ``digipathai_tpu/ops/pallas/bilateral.py``
(``bilateral_message_pallas``, two labels only) with ``csrc/bilateral.cu``:
one thread per pixel over a shared-memory halo tile, bound by instruction
issue (see the source).  Any number of labels: the wrapper launches once
per chunk of up to four.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.  ``bilateral_message.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

#: labels one launch handles (the kernel's register accumulators)
MAX_LABELS = 4


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
    from .. import _build

    lib = _build.load("bilateral")
    q = q.contiguous()
    image = image.contiguous()
    h, w, n_labels = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    inv2_xy = 0.5 / (float(sigma_xy) * float(sigma_xy))
    inv2_c = 0.5 / (float(sigma_rgb) * float(sigma_rgb))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        for l0 in range(0, n_labels, MAX_LABELS):
            nl = min(MAX_LABELS, n_labels - l0)
            rc = lib.dpai_bilateral_message(
                q.data_ptr(), image.data_ptr(), out.data_ptr(), h, w,
                n_labels, l0, nl, radius, inv2_xy, inv2_c, stream)
            if rc != 0:
                raise RuntimeError(
                    f"bilateral_message: kernel launch failed with CUDA error "
                    f"{rc} (H={h} W={w} L={n_labels} r={radius})")
            bilateral_message.launches += 1
    return out


bilateral_message.launches = 0
