"""A plain reader of tiled JPEG TIFFs: the slides the benchmark writes and
the pyramids the program writes.

Each IFD is one level; its tiles are JPEG streams (with the page's
``JPEGTables`` spliced in front where the file has them) decoded by PIL.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np

_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 7: ("B", 1),
          16: ("Q", 8)}


@dataclass
class Level:
    width: int
    height: int
    tile_w: int
    tile_h: int
    offsets: list
    counts: list
    compression: int
    tables: bytes


def _values(buf, order, ftype, count, at, inline):
    ch, size = _TYPES[ftype]
    raw = inline if count * size <= 4 else buf[at:at + count * size]
    if ftype in (1, 2, 7):
        return list(raw[:count])
    return list(struct.unpack(order + ch * count, raw[:count * size]))


def read_levels(path: str) -> list:
    """Every IFD of a classic TIFF as a ``Level``."""
    with open(path, "rb") as f:
        buf = f.read()
    order = "<" if buf[:2] == b"II" else ">"
    if struct.unpack(order + "H", buf[2:4])[0] != 42:
        raise ValueError(f"{path}: not a classic TIFF")
    (at,) = struct.unpack(order + "I", buf[4:8])
    levels = []
    while at:
        (n,) = struct.unpack(order + "H", buf[at:at + 2])
        tags = {}
        for i in range(n):
            e = at + 2 + 12 * i
            tag, ftype, count = struct.unpack(order + "HHI", buf[e:e + 8])
            inline = buf[e + 8:e + 12]
            (ptr,) = struct.unpack(order + "I", inline)
            if ftype in _TYPES:
                tags[tag] = _values(buf, order, ftype, count, ptr, inline)
        tables = bytes(tags.get(347, b""))
        levels.append(Level(tags[256][0], tags[257][0], tags[322][0],
                            tags[323][0], tags[324], tags[325], tags[259][0],
                            tables))
        (at,) = struct.unpack(order + "I", buf[at + 2 + 12 * n:
                                               at + 2 + 12 * n + 4])
    return levels


def _decode(data: bytes, tables: bytes, channels: int) -> np.ndarray:
    from PIL import Image

    if tables and data[:2] == b"\xff\xd8":
        # abbreviated stream: the tables' segments (without their EOI),
        # then the tile's (without its SOI)
        data = tables[:-2] + data[2:]
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if channels == 3 else "L")
    return np.asarray(img)


def read_level(path: str, index: int, channels: int = 3) -> np.ndarray:
    """Level ``index`` (negative counts from the coarsest) of ``path`` as
    an (H, W[, 3]) uint8 array."""
    levels = read_levels(path)
    lv = levels[index]
    if lv.compression != 7:
        raise ValueError(f"{path}: level {index} is not JPEG-compressed "
                         f"(compression {lv.compression})")
    with open(path, "rb") as f:
        buf = f.read()
    th, tw = lv.tile_h, lv.tile_w
    nx = -(-lv.width // tw)
    shape = (lv.height, lv.width) + ((3,) if channels == 3 else ())
    out = np.zeros(shape, np.uint8)
    for i, (off, cnt) in enumerate(zip(lv.offsets, lv.counts)):
        ty, tx = divmod(i, nx)
        if cnt == 0:
            continue
        tile = _decode(buf[off:off + cnt], lv.tables, channels)
        y0, x0 = ty * th, tx * tw
        h = min(th, lv.height - y0)
        w = min(tw, lv.width - x0)
        out[y0:y0 + h, x0:x0 + w] = tile[:h, :w]
    return out
