"""Hamamatsu VMS / VMU slide reader (directory-sibling formats).

The reference opens these through OpenSlide's ``hamamatsu`` driver
(``reference DigiPathAI/main_server.py:54-55``).  A ``.vms`` slide is an
INI-style index file next to its payload files:

    [Virtual Microscope Specimen]
    NoLayers=1
    NoJpegColumns=2 / NoJpegRows=1    JPEG-file grid forming level 0
    ImageFile=...jpg                  column 0 (row 0, layer 0)
    ImageFile(1)=...jpg               column 1; ImageFile(c,r) for rows
    MapFile=...jpg                    low-res map of the whole specimen
    MacroImage=...jpg                 macro photo
    OptimisationFile=...opt           MCU-row seek table (optional here)
    PhysicalWidth/PhysicalHeight      nm of the full image

Each column file is ONE big JPEG with DRI restart markers, i.e. exactly the
NDPI stream shape — the restart-marker surgery from ``io/ndpi.py``
(header parse, SOF patch, RST renumbering, banded decode) is reused, with
the RST index built by scanning the entropy stream (the optimisation file
is redundant given the scan, and scanners emit it inconsistently).

``.vmu`` is the uncompressed variant (section ``[Uncompressed Virtual
Microscope Specimen]``) whose ImageFile is an NGR raw file: ``GN`` magic,
int32 LE width/height at offsets 4/8, column width at 12, pixel-data file
offset at 24; 16-bit RGB samples stored column-block-major.  Pixels are
mapped to 8-bit by taking the high byte (as OpenSlide does).

Like OpenSlide, one pyramid level is exposed (the stitched JPEG grid);
``map`` and ``macro`` become associated images.

Caveat (as for MRXS, io/mirax.py): no real scanner output exists in this
offline environment — layouts are validated against self-authored fixtures
(``tests/fixtures.py: make_vms_slide / make_vmu_slide``).
"""

from __future__ import annotations

import configparser
import os
import struct
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .ndpi import (_decode_jpeg, _patch_sof, _renumber_rsts,
                   parse_jpeg_header)

_VMS_SECTION = "Virtual Microscope Specimen"
_VMU_SECTION = "Uncompressed Virtual Microscope Specimen"
_BAND_CACHE_BYTES = 64 << 20


from .pageinfo import SyntheticPage as _VmsPage  # noqa: E402


class _JpegColumn:
    """Banded random access into one VMS column JPEG (restart surgery)."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self.stream_len = os.fstat(self._fd).st_size
            head = os.pread(self._fd, min(65536, self.stream_len), 0)
            self.info = parse_jpeg_header(head, 0)
        except BaseException:
            # a corrupt-header reject must not leak the fd just opened
            # (VmsReader's cleanup only sees columns already appended)
            self.close()
            raise
        self.width = self.info.width
        self.height = self.info.height
        mcus_per_row = -(-self.width // self.info.mcu_w)
        self.segs_per_row = (
            mcus_per_row // self.info.dri
            if self.info.dri and mcus_per_row % self.info.dri == 0 else 0)
        self._rsts: Optional[np.ndarray] = None

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _rst_index(self) -> np.ndarray:
        if self._rsts is not None:
            return self._rsts
        out = []
        chunk = 64 << 20
        pos = self.info.entropy_start
        carry = b""
        while pos < self.stream_len:
            data = carry + os.pread(self._fd,
                                    min(chunk, self.stream_len - pos), pos)
            buf = np.frombuffer(data, np.uint8)
            ff = np.flatnonzero(buf[:-1] == 0xFF)
            nxt = buf[ff + 1]
            rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
            out.append(rst.astype(np.int64) + pos - len(carry))
            carry = data[-1:]
            pos += min(chunk, self.stream_len - pos)
        self._rsts = (np.concatenate(out) if out
                      else np.zeros(0, np.int64))
        return self._rsts

    def decode_whole(self) -> np.ndarray:
        return _decode_jpeg(os.pread(self._fd, self.stream_len, 0))[
            :self.height, :self.width]

    def decode_rows(self, mcu_row0: int, mcu_row1: int) -> np.ndarray:
        """Full-width pixel rows for MCU rows [mcu_row0, mcu_row1)."""
        if not self.segs_per_row:
            return self.decode_whole()[mcu_row0 * self.info.mcu_h:
                                       mcu_row1 * self.info.mcu_h]
        rsts = self._rst_index()
        spr = self.segs_per_row
        seg0, seg1 = mcu_row0 * spr, mcu_row1 * spr
        if seg0 > 0 and seg0 - 1 >= len(rsts):
            raise ValueError(
                f"{self.path}: restart index has {len(rsts)} markers but "
                f"MCU row {mcu_row0} needs segment {seg0} (corrupt entropy "
                "stream)")  # same guard as io/ndpi.py _decode_rows
        start = (self.info.entropy_start if seg0 == 0
                 else int(rsts[seg0 - 1]) + 2)
        end = (int(rsts[seg1 - 1]) if seg1 - 1 < len(rsts)
               else self.stream_len)
        rows_px = min(self.height - mcu_row0 * self.info.mcu_h,
                      (mcu_row1 - mcu_row0) * self.info.mcu_h)
        header = _patch_sof(self.info.header, self.info.sof_pos,
                            self.width, rows_px)
        entropy = bytearray(os.pread(self._fd, end - start, start))
        if entropy[-2:] == b"\xff\xd9":
            del entropy[-2:]
        stream = header + bytes(_renumber_rsts(entropy)) + b"\xff\xd9"
        return _decode_jpeg(stream)[:rows_px, :self.width]


class _NgrFile:
    """Hamamatsu NGR raw image (VMU): 16-bit RGB, column-block-major."""

    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDONLY)
        try:
            head = os.pread(self._fd, 28, 0)
            if head[:2] != b"GN":
                raise ValueError(f"{path}: not an NGR file")
            self.width, self.height, self.col_width = struct.unpack_from(
                "<iii", head, 4)
            (self.data_off,) = struct.unpack_from("<i", head, 24)
            if self.width <= 0 or self.height <= 0 or self.data_off < 0:
                raise ValueError(f"{path}: invalid NGR geometry "
                                 f"{self.width}x{self.height}@{self.data_off}")
            if self.col_width <= 0 or self.width % self.col_width:
                raise ValueError(f"{path}: column width {self.col_width} "
                                 f"does not divide width {self.width}")
        except BaseException:
            # a corrupt-header reject must not leak the fd just opened
            self.close()
            raise

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def read(self, x: int, y: int, w: int, h: int) -> np.ndarray:
        out = np.zeros((h, w, 3), np.uint8)
        cw = self.col_width
        for cb in range(x // cw, min((x + w - 1) // cw,
                                     self.width // cw - 1) + 1):
            # one column block: (height, cw, 3) uint16 LE, row-major
            base = self.data_off + cb * self.height * cw * 6
            y1 = min(y + h, self.height)
            if y >= y1:
                continue
            raw = os.pread(self._fd, (y1 - y) * cw * 6, base + y * cw * 6)
            arr = np.frombuffer(raw, "<u2").reshape(y1 - y, cw, 3)
            cx0 = max(x, cb * cw)
            cx1 = min(x + w, (cb + 1) * cw)
            out[:y1 - y, cx0 - x:cx1 - x] = (
                arr[:, cx0 - cb * cw:cx1 - cb * cw] >> 8).astype(np.uint8)
        return out


class VmsReader:
    """TiffReader-interface reader for Hamamatsu VMS/VMU slides."""

    def __init__(self, path: str):
        self.path = str(path)
        ini = configparser.ConfigParser(strict=False, interpolation=None)
        with open(path, encoding="utf-8-sig") as f:
            try:
                ini.read_file(f)
            except configparser.Error as e:
                # reader contract: corrupt metadata surfaces as ValueError,
                # never configparser.Error (tests/test_corrupt_inputs.py)
                raise ValueError(f"{path}: corrupt VMS index: {e}") from e
        if ini.has_section(_VMS_SECTION):
            self.uncompressed = False
            sec = ini[_VMS_SECTION]
        elif ini.has_section(_VMU_SECTION):
            self.uncompressed = True
            sec = ini[_VMU_SECTION]
        else:
            raise ValueError(f"{path}: not a VMS/VMU index file")
        base = os.path.dirname(os.path.abspath(path))

        def resolve(name):
            if name not in sec or not sec[name].strip():
                # malformed index: surface as ValueError (the error family
                # the io layer's callers handle), not a raw KeyError
                raise ValueError(
                    f"{path}: VMS/VMU index is missing {name}")
            return os.path.join(base, sec[name].strip())

        cols = int(sec.get("NoJpegColumns", "1") or 1)
        rows = int(sec.get("NoJpegRows", "1") or 1)
        if rows != 1:
            raise ValueError("multi-row VMS grids are not supported")
        if cols < 1:
            raise ValueError(f"{path}: invalid NoJpegColumns {cols}")
        self._cols: List = []
        try:
            for c in range(cols):
                key = "ImageFile" if c == 0 else f"ImageFile({c})"
                if key not in sec and c == 0:
                    key = "ImageFile(0)"
                p = resolve(key)
                self._cols.append(_NgrFile(p) if self.uncompressed
                                  else _JpegColumn(p))
            self._xs = np.cumsum([0] + [c.width for c in self._cols])
            w0, h0 = int(self._xs[-1]), self._cols[0].height
            if any(c.height != h0 for c in self._cols):
                raise ValueError("VMS column heights disagree")
        except BaseException:
            # a corrupt-index reject must not leak the columns already
            # opened: the server retries Slide(path) per tile request
            for col in self._cols:
                try:
                    col.close()
                except Exception:
                    pass
            raise

        self.pages: List[_VmsPage] = [_VmsPage(w0, h0)]
        self._assoc_files = {}
        for key, name in (("MapFile", "map"), ("MacroImage", "macro")):
            if key in sec and sec[key].strip():
                from PIL import Image

                p = resolve(key)
                try:  # header-only probe; a bad associated image must not
                    with Image.open(p) as im:  # make the pyramid unopenable
                        size = im.width, im.height
                except Exception:
                    continue
                self._assoc_files[name] = p
                self.pages.append(_VmsPage(*size))

        self.properties = {}
        pw = float(sec.get("PhysicalWidth", "0") or 0)  # nm
        if pw > 0:
            self.properties["mpp"] = pw / w0 / 1000.0
        self.bounds = None
        self._lock = threading.Lock()
        self._bands: "OrderedDict[Tuple[int, int], np.ndarray]" = OrderedDict()
        self._band_bytes = 0

    # -- banded access across the column grid -------------------------------

    def _band(self, ci: int, band: int, band_mcu_rows: int) -> np.ndarray:
        key = (ci, band)
        with self._lock:
            arr = self._bands.get(key)
            if arr is not None:
                self._bands.move_to_end(key)
                return arr
        col = self._cols[ci]
        total = -(-col.height // col.info.mcu_h)
        r0 = band * band_mcu_rows
        arr = col.decode_rows(r0, min(r0 + band_mcu_rows, total))
        with self._lock:
            self._bands[key] = arr
            self._band_bytes += arr.nbytes
            while self._band_bytes > _BAND_CACHE_BYTES and len(self._bands) > 1:
                _, old = self._bands.popitem(last=False)
                self._band_bytes -= old.nbytes
        return arr

    def read_region(self, idx: int, x: int, y: int, w: int,
                    h: int) -> np.ndarray:
        if idx > 0:  # associated image page
            from PIL import Image

            name = list(self._assoc_files)[idx - 1]
            with Image.open(self._assoc_files[name]) as im:
                arr = np.asarray(im.convert("RGB"), np.uint8)
            out = np.zeros((h, w, 3), np.uint8)
            sub = arr[y:y + h, x:x + w]
            out[:sub.shape[0], :sub.shape[1]] = sub
            return out

        page = self.pages[0]
        out = np.zeros((h, w, 3), np.uint8)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, page.width), min(y + h, page.height)
        if x0 >= x1 or y0 >= y1:
            return out
        for ci, col in enumerate(self._cols):
            cx0, cx1 = int(self._xs[ci]), int(self._xs[ci + 1])
            ix0, ix1 = max(x0, cx0), min(x1, cx1)
            if ix0 >= ix1:
                continue
            if self.uncompressed:
                sub = col.read(ix0 - cx0, y0, ix1 - ix0, y1 - y0)
                out[y0 - y:y1 - y, ix0 - x:ix1 - x] = sub
                continue
            band_mcu_rows = max(1, -(-256 // col.info.mcu_h))
            band_px = band_mcu_rows * col.info.mcu_h
            for band in range(y0 // band_px, (y1 - 1) // band_px + 1):
                arr = self._band(ci, band, band_mcu_rows)
                by0 = band * band_px
                iy0, iy1 = max(y0, by0), min(y1, by0 + arr.shape[0])
                if iy0 >= iy1:
                    continue
                out[iy0 - y:iy1 - y, ix0 - x:ix1 - x] = \
                    arr[iy0 - by0:iy1 - by0, ix0 - cx0:ix1 - cx0]
        return out

    def close(self):
        for c in self._cols:
            c.close()


def detect_vms(path: str) -> Optional[str]:
    """'hamamatsu' if ``path`` is a .vms/.vmu file carrying the index
    section header (mirrors OpenSlide's driver name for all Hamamatsu
    formats).  Detection is header-only; missing/corrupt payload files
    surface as ValueError/OSError when the slide is actually opened."""
    p = str(path)
    if not p.lower().endswith((".vms", ".vmu")):
        return None
    try:
        with open(p, "rb") as f:
            head = f.read(4096).decode("utf-8", "replace")
    except OSError:
        return None
    if (f"[{_VMS_SECTION}]" in head) or (f"[{_VMU_SECTION}]" in head):
        return "hamamatsu"
    return None
