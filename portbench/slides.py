"""Slides made from a seed: the traffic of every cell.

``render_he_like`` gives the pixels of the repository's test fixture of
the same name (white glass, two pink tissue ellipses, a dark lesion, and
Gaussian noise drawn from the seed), frozen here: the tissue layout is the
same for every seed, so every seed plans the same work and only the
pixels differ.
``write_tiled_pyramid`` writes an RGB image as a tiled, pyramidal TIFF
with a standalone JPEG per 256 px tile (quality 92, YCbCr), levels halved
by 2x2 means until the longest side fits in one tile, as the fixtures'
slides are laid out.  A traffic file's ``slide`` entry picks the layout:

- ``he_like``: ``render_he_like`` over the whole slide;
- ``sparse``: glass of value ``glass`` with one ``render_he_like`` block of
  ``block`` = [width, height] at ``offset`` = [x, y].
"""

from __future__ import annotations

import io
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TILE = 256
QUALITY = 92
THREADS = 4  # JPEG encoders

# TIFF tags and field types used here
_W, _H, _BPS, _COMP, _PHOTO, _SPP = 256, 257, 258, 259, 262, 277
_TW, _TL, _TOFF, _TBC = 322, 323, 324, 325
_SHORT, _LONG = 3, 4
_JPEG, _YCBCR, _GREY = 7, 6, 1


def render_he_like(width: int, height: int, seed: int = 0) -> np.ndarray:
    """An H&E-like RGB image (H, W, 3) uint8: white glass, pink tissue, a
    dark lesion.  The fixture's pixels to the bit, computed 256 rows at a
    time (the noise is drawn in the same order)."""
    rows = 256
    rng = np.random.default_rng(seed)
    img = np.empty((height, width, 3), np.uint8)
    xx = np.arange(width, dtype=np.float32)[None, :]
    pink = np.array([222, 154, 190], np.float32)  # eosin-ish
    dark = np.array([120, 60, 130], np.float32)   # hematoxylin-ish lesion

    def ellipse(yy, cx, cy, rx, ry):
        f = np.float32
        return ((xx - f(cx)) / f(rx)) ** 2 + ((yy - f(cy)) / f(ry)) ** 2 <= 1

    for y0 in range(0, height, rows):
        y1 = min(height, y0 + rows)
        yy = np.arange(y0, y1, dtype=np.float32)[:, None]
        tissue = ellipse(yy, width * 0.32, height * 0.45, width * 0.22,
                         height * 0.33)
        tissue |= ellipse(yy, width * 0.70, height * 0.60, width * 0.18,
                          height * 0.26)
        lesion = ellipse(yy, width * 0.32, height * 0.45, width * 0.09,
                         height * 0.13)
        noise = rng.normal(0, 6, size=(y1 - y0, width, 3))
        base = np.where(tissue[..., None], pink, 244.0)
        base = np.where(lesion[..., None], dark, base)
        img[y0:y1] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img


def render(spec: dict, seed: int) -> np.ndarray:
    """The (H, W, 3) uint8 image of a traffic file's slide entry."""
    w, h = int(spec["width"]), int(spec["height"])
    layout = spec.get("layout", "he_like")
    if layout == "he_like":
        return render_he_like(w, h, seed)
    if layout == "sparse":
        img = np.full((h, w, 3), int(spec["glass"]), np.uint8)
        bw, bh = (int(v) for v in spec["block"])
        ox, oy = (int(v) for v in spec["offset"])
        img[oy:oy + bh, ox:ox + bw] = render_he_like(bw, bh, seed)
        return img
    raise ValueError(f"unknown slide layout {layout!r}")


def _encode_jpeg(tile: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(tile).save(buf, "jpeg", quality=quality)
    return buf.getvalue()


def _half(img: np.ndarray) -> np.ndarray:
    """2x2 mean, rounded half to even, of an (H, W[, 3]) uint8 image (odd
    edges dropped); the sum of four uint8 values is exact in float32."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    a = img[:2 * h, :2 * w].astype(np.float32)
    s = a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]
    return np.round(s * 0.25).astype(np.uint8)


def _ifd(entries) -> tuple:
    """(table bytes, blob bytes) of one IFD placed at offset 0; the caller
    rebases the blob offsets.  ``entries``: (tag, type, values)."""
    sizes = {_SHORT: ("H", 2), _LONG: ("I", 4)}
    entries = sorted(entries)
    n = len(entries)
    table_size = 2 + 12 * n + 4
    table, blobs = [struct.pack("<H", n)], []
    blob_at = table_size
    for tag, ftype, values in entries:
        ch, size = sizes[ftype]
        payload = struct.pack("<" + ch * len(values), *values)
        if len(payload) <= 4:
            table.append(struct.pack("<HHI", tag, ftype, len(values))
                         + payload.ljust(4, b"\0"))
        else:
            table.append(struct.pack("<HHII", tag, ftype, len(values),
                                     blob_at))
            blobs.append(payload)
            blob_at += len(payload)
    table.append(b"\0\0\0\0")  # the next IFD's offset, patched later
    return b"".join(table), b"".join(blobs), table_size


def write_tiled_pyramid(path: str, img: np.ndarray,
                        quality: int = QUALITY) -> list:
    """Write ``img``, (H, W, 3) RGB or (H, W) grey, as a tiled pyramidal
    JPEG TIFF; returns the levels' (width, height)."""
    rgb = img.ndim == 3
    levels = [img]
    while max(levels[-1].shape[:2]) > TILE:
        levels.append(_half(levels[-1]))
    dims = []
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 0))
        prev_ptr = 4
        for lvl in levels:
            h, w = lvl.shape[:2]
            dims.append((w, h))
            offsets, counts = [], []

            def encode(at, lvl=lvl):
                ty, tx = at
                block = np.full((TILE, TILE) + lvl.shape[2:], 255, np.uint8)
                sub = lvl[ty:ty + TILE, tx:tx + TILE]
                block[:sub.shape[0], :sub.shape[1]] = sub
                return _encode_jpeg(block, quality)

            grid = [(ty, tx) for ty in range(0, h, TILE)
                    for tx in range(0, w, TILE)]
            # PIL encodes without the GIL: the tiles go in parallel, and
            # are written in order
            with ThreadPoolExecutor(THREADS) as ex:
                for data in ex.map(encode, grid):
                    offsets.append(f.tell())
                    counts.append(len(data))
                    f.write(data)
            if f.tell() % 2:
                f.write(b"\0")
            at = f.tell()
            table, blobs, size = _ifd([
                (_W, _LONG, [w]), (_H, _LONG, [h]),
                (_BPS, _SHORT, [8, 8, 8] if rgb else [8]),
                (_COMP, _SHORT, [_JPEG]),
                (_PHOTO, _SHORT, [_YCBCR if rgb else _GREY]),
                (_SPP, _SHORT, [3 if rgb else 1]),
                (_TW, _SHORT, [TILE]), (_TL, _SHORT, [TILE]),
                (_TOFF, _LONG, offsets), (_TBC, _LONG, counts)])
            # rebase the out-of-line values to where this IFD lands
            fixed = bytearray(table)
            for i in range((len(table) - 6) // 12):  # the entries
                e = 2 + 12 * i
                tag, ftype, count = struct.unpack_from("<HHI", fixed, e)
                if count * (2 if ftype == _SHORT else 4) > 4:
                    (off,) = struct.unpack_from("<I", fixed, e + 8)
                    struct.pack_into("<I", fixed, e + 8, off + at)
            f.write(bytes(fixed))
            f.write(blobs)
            end = f.tell()
            f.seek(prev_ptr)
            f.write(struct.pack("<I", at))
            f.seek(end)
            prev_ptr = at + size - 4
    return dims
