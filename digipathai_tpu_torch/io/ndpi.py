"""Hamamatsu NDPI reader (restart-marker JPEG surgery, first-party).

NDPI is a classic little-endian TIFF whose IFDs hold one full JPEG stream
per strip (old-style Compression=6) plus private tags: 65420 (format
marker), 65421 SourceLens (magnification; -1 = macro image, -2 = whole
slide "map"), 65422/65423 lens X/Y offsets, 65426 McuStarts (byte offsets
of the restart-marker segments inside the stream).  Two quirks make the
generic TIFF path unusable on real scans:

- level-0 dimensions routinely exceed JPEG's 65535 limit, so the stream's
  SOF records ``dim % 65536`` and the TIFF tags hold the truth;
- a level is ONE multi-hundred-MB JPEG, so region reads must decode only
  the needed MCU rows.

This reader does what OpenSlide's NDPI driver does, in pure Python: it
parses the JPEG header once per level, indexes the restart markers
(preferring the McuStarts table, falling back to a chunked scan of the
entropy stream), and serves ``read_region`` by splicing a minimal JPEG —
patched SOF dimensions, the selected restart segments with their RST
markers renumbered, EOI — and handing it to the codec.  Restart markers
reset the DC predictors, so sliced decodes are bit-identical to decoding
the whole stream (asserted in tests/test_ndpi.py).

Decoded full-width MCU row bands are LRU-cached so the patch loader's
supertile sweeps don't re-decode bands (JPEG cannot skip columns, so the
band is the natural cache unit).

Reference capability being reproduced: the reference opens NDPI via
OpenSlide (``reference DigiPathAI/main_server.py:54-55``,
``loaders/dataloader.py:239``).
"""

from __future__ import annotations

import io
import struct
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .tiff_py import COMPRESSION_OLD_JPEG, TiffPage, TiffReader

NDPI_MAGIC = 65420
NDPI_SOURCELENS = 65421
NDPI_MCU_STARTS = 65426

# levels at or below this many pixels are decoded whole and cached
_FULL_DECODE_PX = 1 << 24  # 16 MP
_BAND_CACHE_BYTES = 256 << 20


class _JpegInfo:
    """Parsed stream geometry for one NDPI level."""

    __slots__ = ("header", "sof_pos", "entropy_start", "stream_off",
                 "stream_len", "mcu_w", "mcu_h", "dri", "width", "height",
                 "rst_offsets", "segs_per_row")

    def __init__(self):
        self.rst_offsets: Optional[np.ndarray] = None
        self.sof_pos = -1  # sentinel: no SOF seen yet (corrupt-file guard)


def _be16(b: bytes, off: int = 0) -> int:
    return (b[off] << 8) | b[off + 1]


def parse_jpeg_header(head: bytes, stream_off: int) -> _JpegInfo:
    """Walk the JPEG segments up to SOS; ``head`` must cover them all."""
    if head[:2] != b"\xff\xd8":
        raise ValueError("NDPI strip is not a JPEG stream")
    info = _JpegInfo()
    info.stream_off = stream_off
    info.dri = 0
    pos = 2
    while pos + 4 <= len(head):
        if head[pos] != 0xFF:
            raise ValueError(f"bad JPEG marker sync at {pos}")
        marker = head[pos + 1]
        if marker == 0xDA:  # SOS: entropy data follows the segment
            if info.sof_pos < 0:
                # mcu_w/h, width/height would be unset (AttributeError on
                # __slots__) — keep the reader contract on corrupt streams
                raise ValueError("JPEG stream has SOS before any SOF frame")
            seglen = _be16(head, pos + 2)
            info.entropy_start = pos + 2 + seglen
            info.header = bytes(head[:info.entropy_start])
            return info
        seglen = _be16(head, pos + 2)
        if marker in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            ncomp = head[pos + 9] if pos + 9 < len(head) else 0
            if pos + 10 + 3 * ncomp > len(head):
                raise ValueError("truncated JPEG SOF segment")
            info.sof_pos = pos
            info.height = _be16(head, pos + 5)
            info.width = _be16(head, pos + 7)
            hmax = vmax = 1
            for c in range(ncomp):
                hv = head[pos + 10 + 3 * c + 1]
                hmax = max(hmax, hv >> 4)
                vmax = max(vmax, hv & 0xF)
            info.mcu_w, info.mcu_h = 8 * hmax, 8 * vmax
        elif marker == 0xDD:  # DRI
            if pos + 6 > len(head):  # loop guard only covers pos+3
                raise ValueError("truncated JPEG DRI segment")
            info.dri = _be16(head, pos + 4)
        pos += 2 + seglen
    raise ValueError("no SOS marker found in JPEG header")


def _patch_sof(header: bytes, sof_pos: int, width: int, height: int) -> bytes:
    h = bytearray(header)
    h[sof_pos + 5:sof_pos + 7] = struct.pack(">H", height)
    h[sof_pos + 7:sof_pos + 9] = struct.pack(">H", width)
    return bytes(h)


def _renumber_rsts(entropy: bytearray) -> bytearray:
    """Renumber RST markers sequentially from 0 (required after slicing)."""
    n = 0
    i = entropy.find(b"\xff", 0)
    while 0 <= i < len(entropy) - 1:
        m = entropy[i + 1]
        if 0xD0 <= m <= 0xD7:
            entropy[i + 1] = 0xD0 + (n & 7)
            n += 1
        i = entropy.find(b"\xff", i + 1)
    return entropy


def _decode_jpeg(stream: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(stream))
    arr = np.asarray(img.convert("RGB"))
    return arr


class NdpiReader:
    """``TiffReader``-interface reader for Hamamatsu NDPI slides."""

    def __init__(self, path: str, tile_cache_size: int = 64):
        self.path = str(path)
        self._r = TiffReader(path, tile_cache_size=tile_cache_size)
        self.pages: List[TiffPage] = self._r.pages
        self._lock = threading.Lock()
        self._info: dict = {}
        self._whole: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._bands: "OrderedDict[Tuple[int, int], np.ndarray]" = OrderedDict()
        self._band_bytes = 0

    # -- plumbing -----------------------------------------------------------

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def source_lens(page: TiffPage) -> Optional[float]:
        v = page.ndpi.get(NDPI_SOURCELENS)
        if v is None:
            return None
        return float(v[0] if isinstance(v, (list, tuple, np.ndarray)) else v)

    # -- JPEG stream geometry ------------------------------------------------

    def _page_info(self, idx: int) -> _JpegInfo:
        with self._lock:
            info = self._info.get(idx)
        if info is not None:
            return info
        page = self.pages[idx]
        if not page.strip_offsets:
            raise ValueError("NDPI page has no strip data")
        off = page.strip_offsets[0]
        head = self._r._pread(off, min(65536, page.strip_counts[0]))
        info = parse_jpeg_header(head, off)
        info.stream_len = page.strip_counts[0]
        # TIFF tags are the true dimensions (JPEG SOF wraps at 65536)
        info.width, info.height = page.width, page.height
        mcus_per_row = -(-info.width // info.mcu_w)
        info.segs_per_row = (mcus_per_row // info.dri
                             if info.dri and mcus_per_row % info.dri == 0
                             else 0)
        with self._lock:
            self._info[idx] = info
        return info

    def _rst_index(self, idx: int, info: _JpegInfo) -> np.ndarray:
        """Byte offsets (into the stream) of each RST marker, in order."""
        if info.rst_offsets is not None:
            return info.rst_offsets
        page = self.pages[idx]
        starts = self._r.read_lazy_tag(page, NDPI_MCU_STARTS)
        offsets = None
        if starts is not None and len(starts) > 1:
            # McuStarts[k] = offset of restart segment k; markers sit 2 bytes
            # before each segment after the first. Validate against the
            # stream before trusting it.
            cand = np.asarray(starts[1:], np.int64) - 2
            probe = self._r._pread(info.stream_off + int(cand[0]), 2)
            if probe[0] == 0xFF and 0xD0 <= probe[1] <= 0xD7:
                offsets = cand
        if offsets is None:
            offsets = self._scan_rsts(info)
        info.rst_offsets = offsets
        return offsets

    def _scan_rsts(self, info: _JpegInfo) -> np.ndarray:
        """Chunked scan of the entropy stream for RST markers."""
        out = []
        chunk = 64 << 20
        pos = info.entropy_start
        end = info.stream_len
        carry = b""
        while pos < end:
            data = carry + self._r._pread(
                info.stream_off + pos, min(chunk, end - pos))
            buf = np.frombuffer(data, np.uint8)
            ff = np.flatnonzero(buf[:-1] == 0xFF)
            nxt = buf[ff + 1]
            rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
            base = pos - len(carry)
            out.append(rst.astype(np.int64) + base)
            carry = data[-1:]
            pos += min(chunk, end - pos)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    # -- decoding ------------------------------------------------------------

    def _read_whole(self, idx: int) -> np.ndarray:
        with self._lock:
            arr = self._whole.get(idx)
            if arr is not None:
                self._whole.move_to_end(idx)
                return arr
        page = self.pages[idx]
        info = self._page_info(idx)
        stream = self._r._pread(info.stream_off, info.stream_len)
        if (info.width != _be16(info.header, info.sof_pos + 7)
                or info.height != _be16(info.header, info.sof_pos + 5)):
            stream = (_patch_sof(info.header, info.sof_pos, info.width,
                                 info.height) + stream[info.entropy_start:])
        arr = _decode_jpeg(stream)[:page.height, :page.width]
        with self._lock:
            self._whole[idx] = arr
            while len(self._whole) > 2:
                self._whole.popitem(last=False)
        return arr

    def _decode_rows(self, idx: int, mcu_row0: int, mcu_row1: int) -> np.ndarray:
        """Decode MCU rows [mcu_row0, mcu_row1) at full width via surgery."""
        info = self._page_info(idx)
        rsts = self._rst_index(idx, info)
        spr = info.segs_per_row
        seg0 = mcu_row0 * spr
        seg1 = mcu_row1 * spr
        if seg0 > 0 and seg0 - 1 >= len(rsts):
            raise ValueError(
                f"{self._r.path}: restart index has {len(rsts)} markers but "
                f"MCU row {mcu_row0} needs segment {seg0} (corrupt "
                "McuStarts table or entropy stream)")
        start = info.entropy_start if seg0 == 0 else int(rsts[seg0 - 1]) + 2
        end = int(rsts[seg1 - 1]) if seg1 - 1 < len(rsts) else info.stream_len
        rows_px = min(info.height - mcu_row0 * info.mcu_h,
                      (mcu_row1 - mcu_row0) * info.mcu_h)
        header = _patch_sof(info.header, info.sof_pos, info.width, rows_px)
        entropy = bytearray(self._r._pread(info.stream_off + start,
                                           end - start))
        # strip any trailing EOI from the final segment; we append our own
        if entropy[-2:] == b"\xff\xd9":
            del entropy[-2:]
        stream = header + bytes(_renumber_rsts(entropy)) + b"\xff\xd9"
        return _decode_jpeg(stream)[:rows_px, :info.width]

    def _band(self, idx: int, band: int, band_mcu_rows: int) -> np.ndarray:
        key = (idx, band)
        with self._lock:
            arr = self._bands.get(key)
            if arr is not None:
                self._bands.move_to_end(key)
                return arr
        info = self._page_info(idx)
        total_mcu_rows = -(-info.height // info.mcu_h)
        r0 = band * band_mcu_rows
        r1 = min(r0 + band_mcu_rows, total_mcu_rows)
        arr = self._decode_rows(idx, r0, r1)
        with self._lock:
            self._bands[key] = arr
            self._band_bytes += arr.nbytes
            while self._band_bytes > _BAND_CACHE_BYTES and len(self._bands) > 1:
                _, old = self._bands.popitem(last=False)
                self._band_bytes -= old.nbytes
        return arr

    # -- public API (TiffReader-compatible) ----------------------------------

    def read_whole(self, idx: int) -> np.ndarray:
        page = self.pages[idx]
        return self.read_region(idx, 0, 0, page.width, page.height)

    def read_region(self, idx: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        page = self.pages[idx]
        if page.compression not in (COMPRESSION_OLD_JPEG, 7):
            return self._r.read_region(idx, x, y, w, h)
        out = np.zeros((h, w, 3), np.uint8)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, page.width), min(y + h, page.height)
        if x0 >= x1 or y0 >= y1:
            return out

        info = self._page_info(idx)
        small = page.width * page.height <= _FULL_DECODE_PX
        if small or not info.segs_per_row:
            whole = self._read_whole(idx)
            out[y0 - y:y1 - y, x0 - x:x1 - x] = whole[y0:y1, x0:x1]
            return out

        # band size: >=256 px of rows, in whole MCU rows
        band_mcu_rows = max(1, -(-256 // info.mcu_h))
        band_px = band_mcu_rows * info.mcu_h
        for band in range(y0 // band_px, (y1 - 1) // band_px + 1):
            arr = self._band(idx, band, band_mcu_rows)
            by0 = band * band_px
            iy0, iy1 = max(y0, by0), min(y1, by0 + arr.shape[0])
            if iy0 >= iy1:
                continue
            out[iy0 - y:iy1 - y, x0 - x:x1 - x] = \
                arr[iy0 - by0:iy1 - by0, x0:x1]
        return out
