"""3DHISTECH Mirax (MRXS) slide reader.

The reference opens MRXS through OpenSlide's ``mirax`` driver
(``reference DigiPathAI/main_server.py:54-55`` — any format
``OpenSlide.detect_format`` accepts).  MRXS is a *directory* format:

    slide.mrxs              small preview image (JPEG/PNG/BMP)
    slide/Slidedat.ini      INI metadata: camera grid, hierarchy, data files
    slide/Index.dat         binary index: per zoom level, tile -> (file,
                            offset, length) records
    slide/Data0000.dat ...  concatenated JPEG/PNG/BMP tile payloads

Layout implemented here (the OpenSlide driver's documented structure):

- ``Slidedat.ini`` ``[GENERAL]``: ``SLIDE_ID``, ``IMAGENUMBER_X/Y`` (the
  level-0 camera grid); ``[HIERARCHICAL]``: ``INDEXFILE``, ``HIER_COUNT``,
  the hier named ``Slide zoom level`` with per-zoom sections
  ``HIER_<i>_VAL_<j>_SECTION``; ``[DATAFILE]``: ``FILE_COUNT``/``FILE_<j>``;
  per-zoom sections: ``DIGITIZER_WIDTH/HEIGHT``, ``OVERLAP_X/Y``,
  ``IMAGE_FORMAT``, ``IMAGE_FILL_COLOR_BGR``, ``MICROMETER_PER_PIXEL_X``.
- ``Index.dat``: 5-byte version, the ``SLIDE_ID`` string, then two little-
  endian int32 offsets (hier root, nonhier root).  The hier root is a table
  of int32 page pointers, one per hier value (all hiers concatenated in
  order).  A page is ``int32 count, int32 next_page_offset`` followed by
  ``count`` records of four int32: ``image_index, offset, length, fileno``.
  For zoom level ``z``, ``image_index = ty * ceil(nx / 2^z) + tx`` in that
  level's tile grid.
- Geometry: a zoom-``z`` tile is DIGITIZER_WIDTH x HEIGHT pixels covering
  ``2^z`` camera positions; tiles advance by ``(W - OVERLAP_X, H -
  OVERLAP_Y)`` level-``z`` pixels, so neighbors overlap and later paints
  win.  Absent camera positions render as the fill color, and the non-empty
  camera bounding box is exposed as ``bounds`` (level-0 px) — MRXS images
  famously start deep inside a huge virtual canvas, which is why
  ``DeepZoomGenerator(limit_bounds=True)`` honors ``Slide.bounds``.

Caveat (documented in PARITY.md): no real MRXS slide ships in this offline
environment, so the binary-index parsing is validated against self-authored
fixtures (``tests/fixtures.py: make_mirax_slide``) that follow the layout
above, not against scanner output.  Vendor quirk handling (position
buffers, camera sub-divisions) is out of scope until a real slide exists.
"""

from __future__ import annotations

import configparser
import os
import struct
import threading
from io import BytesIO
from typing import Dict, Optional, Tuple

import numpy as np


from .pageinfo import SyntheticPage as MiraxPage  # noqa: E402


def _ini_get(ini, section, key, default=None):
    try:
        return ini[section][key]
    except KeyError:
        if default is not None:
            return default
        raise ValueError(f"Slidedat.ini: missing {section}.{key}")


class MiraxReader:
    def __init__(self, path: str):
        self.path = str(path)
        base, _ = os.path.splitext(self.path)
        self.dirname = base
        ini_path = os.path.join(self.dirname, "Slidedat.ini")
        if not os.path.isfile(ini_path):
            raise ValueError(f"{path}: no Slidedat.ini (not a MRXS slide)")
        ini = configparser.ConfigParser(strict=False, interpolation=None)
        # Mirax writes a UTF-8 BOM and occasionally duplicate keys
        with open(ini_path, encoding="utf-8-sig") as f:
            try:
                ini.read_file(f)
            except configparser.Error as e:
                # keep the documented reader contract (ValueError/OSError,
                # io/slide.py:380) on hostile files — configparser.Error
                # is not in it (tests/test_corrupt_inputs.py)
                raise ValueError(f"{path}: corrupt Slidedat.ini: {e}") from e

        g = "GENERAL"
        self.slide_id = _ini_get(ini, g, "SLIDE_ID")
        self.nx = int(_ini_get(ini, g, "IMAGENUMBER_X"))
        self.ny = int(_ini_get(ini, g, "IMAGENUMBER_Y"))

        h = "HIERARCHICAL"
        index_file = _ini_get(ini, h, "INDEXFILE", "Index.dat")
        hier_count = int(_ini_get(ini, h, "HIER_COUNT"))
        counts = [int(_ini_get(ini, h, f"HIER_{i}_COUNT"))
                  for i in range(hier_count)]
        zoom_hier = 0
        for i in range(hier_count):
            name = _ini_get(ini, h, f"HIER_{i}_NAME", "")
            if "zoom" in name.lower():
                zoom_hier = i
                break
        self.zoom_levels = counts[zoom_hier]
        self._hier_base = sum(counts[:zoom_hier])

        d = "DATAFILE"
        nfiles = int(_ini_get(ini, d, "FILE_COUNT"))
        self.data_files = [os.path.join(self.dirname,
                                        _ini_get(ini, d, f"FILE_{i}"))
                           for i in range(nfiles)]

        self._zoom = []
        for j in range(self.zoom_levels):
            sec = _ini_get(ini, h, f"HIER_{zoom_hier}_VAL_{j}_SECTION")
            tw = int(float(_ini_get(ini, sec, "DIGITIZER_WIDTH")))
            th = int(float(_ini_get(ini, sec, "DIGITIZER_HEIGHT")))
            ovx = int(float(_ini_get(ini, sec, "OVERLAP_X", "0")))
            ovy = int(float(_ini_get(ini, sec, "OVERLAP_Y", "0")))
            fmt = _ini_get(ini, sec, "IMAGE_FORMAT", "JPEG").upper()
            fill = int(_ini_get(ini, sec, "IMAGE_FILL_COLOR_BGR", "0"))
            mpp = float(_ini_get(ini, sec, "MICROMETER_PER_PIXEL_X", "0"))
            self._zoom.append(dict(tw=tw, th=th, ovx=ovx, ovy=ovy, fmt=fmt,
                                   fill=fill, mpp=mpp))

        self._tiles = self._parse_index(os.path.join(self.dirname,
                                                     index_file))
        # raw fds read via os.pread: the engine's PatchLoader shares one
        # Slide across num_workers threads (loader.py's thread-safety
        # contract), so per-call seek+read on a shared handle would race
        self._fd: Dict[int, int] = {}
        self._fsize: Dict[int, int] = {}  # data-file size, cached at open
        self._fd_lock = threading.Lock()

        # geometry: level-0 canvas spans the camera grid; each level's
        # advance is (tw - ov) of that level
        z0 = self._zoom[0]
        adv_x = z0["tw"] - z0["ovx"]
        adv_y = z0["th"] - z0["ovy"]
        w0 = (self.nx - 1) * adv_x + z0["tw"] if self.nx else z0["tw"]
        h0 = (self.ny - 1) * adv_y + z0["th"] if self.ny else z0["th"]
        self.pages = []
        for z, zz in enumerate(self._zoom):
            self.pages.append(MiraxPage(
                max(1, -(-w0 // (1 << z))), max(1, -(-h0 // (1 << z))),
                zz["tw"], zz["th"]))

        occ = self._tiles[0] if self._tiles else {}
        if occ:
            txs = [t[0] for t in occ]
            tys = [t[1] for t in occ]
            x0, y0 = min(txs) * adv_x, min(tys) * adv_y
            x1 = max(txs) * adv_x + z0["tw"]
            y1 = max(tys) * adv_y + z0["th"]
            self.bounds = (x0, y0, min(x1, w0) - x0, min(y1, h0) - y0)
        else:
            self.bounds = None

        self.properties = {}
        if z0["mpp"]:
            self.properties["mpp"] = z0["mpp"]

    # -- index ------------------------------------------------------------

    def _parse_index(self, path: str):
        try:
            return self._parse_index_impl(path)
        except (ValueError, OSError):
            raise
        except Exception as e:
            # binary-parser boundary for untrusted bytes (struct.error from
            # corrupt offsets, etc.) — same contract as tiff_py._parse
            raise ValueError(f"{path}: corrupt Index.dat: {e!r}") from e

    def _parse_index_impl(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        pos = 5 + len(self.slide_id.encode())  # version + slide id
        hier_root, _nonhier_root = struct.unpack_from("<ii", data, pos)
        tiles = []
        for j in range(self.zoom_levels):
            (ptr,) = struct.unpack_from(
                "<i", data, hier_root + 4 * (self._hier_base + j))
            across = max(1, -(-self.nx // (1 << j)))
            level: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
            seen_ptrs = set()
            while ptr:
                if ptr in seen_ptrs:
                    # a corrupt next-pointer forming a cycle must not hang
                    # the open (tests/test_corrupt_inputs.py)
                    raise ValueError(
                        f"{path}: cyclic page list in Index.dat at {ptr}")
                seen_ptrs.add(ptr)
                count, nxt = struct.unpack_from("<ii", data, ptr)
                for r in range(count):
                    img, off, ln, fno = struct.unpack_from(
                        "<iiii", data, ptr + 8 + 16 * r)
                    level[(img % across, img // across)] = (fno, off, ln)
                ptr = nxt
            tiles.append(level)
        return tiles

    # -- pixels -----------------------------------------------------------

    def _decode(self, z: int, rec) -> np.ndarray:
        from PIL import Image

        fno, off, ln = rec
        if not 0 <= fno < len(self.data_files):
            raise ValueError(
                f"{self.path}: tile record references data file {fno} of "
                f"{len(self.data_files)} (corrupt Index.dat)")
        fd = self._fd.get(fno)
        if fd is None:
            with self._fd_lock:
                fd = self._fd.get(fno)
                if fd is None:
                    fd = os.open(self.data_files[fno], os.O_RDONLY)
                    # cache the size, then publish the fd (readers on the
                    # lock-free fast path see _fsize only after _fd)
                    self._fsize[fno] = os.fstat(fd).st_size
                    self._fd[fno] = fd
        if ln < 0 or off < 0 or off + ln > self._fsize[fno]:
            # bound the read by the data file BEFORE os.pread allocates the
            # claimed length (same contract as tiff_py._pread)
            raise ValueError(
                f"{self.path}: tile record [{off}, {off + ln}) outside data "
                f"file {fno} (corrupt Index.dat)")
        img = Image.open(BytesIO(os.pread(fd, ln, off)))
        return np.asarray(img.convert("RGB"), np.uint8)

    def read_region(self, level: int, x: int, y: int, w: int,
                    h: int) -> np.ndarray:
        """(h, w, 3) uint8 at ``level``; x/y are level-``level`` pixels."""
        zz = self._zoom[level]
        fill = zz["fill"]
        # little-endian BGR byte order -> int B | G<<8 | R<<16; unpack to RGB
        bg = np.array([(fill >> 16) & 0xFF, (fill >> 8) & 0xFF, fill & 0xFF],
                      np.uint8)
        out = np.empty((h, w, 3), np.uint8)
        out[:] = bg
        adv_x = zz["tw"] - zz["ovx"]
        adv_y = zz["th"] - zz["ovy"]
        tiles = self._tiles[level]
        tx0 = max(0, (x - zz["tw"] + adv_x) // adv_x if adv_x else 0)
        ty0 = max(0, (y - zz["th"] + adv_y) // adv_y if adv_y else 0)
        tx1 = (x + w - 1) // adv_x if adv_x else 0
        ty1 = (y + h - 1) // adv_y if adv_y else 0
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                rec = tiles.get((tx, ty))
                if rec is None:
                    continue
                arr = self._decode(level, rec)
                px, py = tx * adv_x, ty * adv_y
                sx0, sy0 = max(x - px, 0), max(y - py, 0)
                sx1 = min(x + w - px, arr.shape[1])
                sy1 = min(y + h - py, arr.shape[0])
                if sx0 >= sx1 or sy0 >= sy1:
                    continue
                out[py + sy0 - y:py + sy1 - y,
                    px + sx0 - x:px + sx1 - x] = arr[sy0:sy1, sx0:sx1]
        return out

    def close(self):
        with self._fd_lock:
            for fd in self._fd.values():
                os.close(fd)
            self._fd.clear()
            self._fsize.clear()


def detect_mirax(path: str) -> Optional[str]:
    """'mirax' if ``path`` is a .mrxs file with a sibling Slidedat.ini."""
    if not str(path).lower().endswith(".mrxs"):
        return None
    base, _ = os.path.splitext(str(path))
    if os.path.isfile(os.path.join(base, "Slidedat.ini")):
        return "mirax"
    return None
