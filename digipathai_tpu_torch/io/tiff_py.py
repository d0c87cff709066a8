"""Pure-Python tiled pyramidal TIFF reader/writer.

First-party replacement for the reference's third-party slide I/O stack
(OpenSlide reads at ``reference DigiPathAI/loaders/dataloader.py:239,357``,
``tifffile.imsave`` + ImageMagick ``convert ... ptif:`` writes at
``reference DigiPathAI/Segmentation.py:333-352``).  This module is the
portable reference implementation; ``digipathai_tpu_torch.io.native`` provides a
C++/libtiff fast path with the same interface.

Supported on read: classic + BigTIFF, tiled + stripped layout, uncompressed /
deflate / LZW (with horizontal predictor) / JPEG (incl. abbreviated streams
with a shared JPEGTables tag), 8-bit grayscale & RGB(A), 32-bit float.
Supported on write: tiled pyramids, deflate / JPEG / raw, uint8 gray & RGB and
float32 gray, streamed from arbitrarily large (memmap) sources.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

# --- TIFF constants -----------------------------------------------------------

II = b"II"  # little endian
MM = b"MM"  # big endian

TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_XMP = 700  # XML packet; Ventana BIF stores its iScan metadata here
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_X_RESOLUTION = 282
TAG_Y_RESOLUTION = 283
TAG_PLANAR_CONFIG = 284
TAG_RESOLUTION_UNIT = 296
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_JPEG_TABLES = 347

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_OLD_JPEG = 6  # as used by Hamamatsu NDPI (full JFIF strips)
COMPRESSION_JPEG = 7
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_DEFLATE = 32946
COMPRESSION_APERIO_J2K_YCBCR = 33003  # Aperio SVS: JPEG2000 codestream, YCbCr
COMPRESSION_APERIO_J2K_RGB = 33005    # Aperio SVS: JPEG2000 codestream, RGB

PHOTOMETRIC_MINISWHITE = 0
PHOTOMETRIC_MINISBLACK = 1
PHOTOMETRIC_RGB = 2
PHOTOMETRIC_PALETTE = 3
PHOTOMETRIC_YCBCR = 6

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_FLOAT = 3

# Private tags whose value arrays can be huge (NDPI restart-marker offset
# tables); parsed lazily via TiffReader.read_lazy_tag.
_LAZY_TAGS = frozenset({65426, 65432, 65433})

# field type -> (struct char, size)
_TYPE_INFO = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL (2x LONG)
    6: ("b", 1),   # SBYTE
    7: ("B", 1),   # UNDEFINED
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    10: ("ii", 8),  # SRATIONAL
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    13: ("I", 4),  # IFD
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8
    18: ("Q", 8),  # IFD8
}


# --- LZW (TIFF flavor) --------------------------------------------------------


def lzw_decode(data: bytes, max_out: Optional[int] = None) -> bytes:
    """Decode TIFF-flavor LZW (MSB-first bit packing, early code-size change).

    ``max_out`` bounds the decoded size: LZW expands up to ~2700x, so a
    corrupt/hostile block must not be allowed to balloon past the size the
    tile/strip geometry implies (tests/test_corrupt_inputs.py).
    """
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes((i,)) for i in range(256)] + [b"", b""]

    reset_table()
    bits, acc, nacc = 9, 0, 0
    prev: Optional[bytes] = None
    for byte in data:
        acc = (acc << 8) | byte
        nacc += 8
        while nacc >= bits:
            code = (acc >> (nacc - bits)) & ((1 << bits) - 1)
            nacc -= bits
            if code == CLEAR:
                reset_table()
                bits = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                if code >= len(table):
                    raise ValueError(f"corrupt LZW stream: first code {code} "
                                     "references an empty table")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            if max_out is not None and len(out) >= max_out:
                return bytes(out[:max_out])
            # TIFF uses "early change": bump width one code early.
            if len(table) + 1 >= (1 << bits) and bits < 12:
                bits += 1
    return bytes(out)


def _undo_horizontal_predictor(arr: np.ndarray) -> np.ndarray:
    # arr: (rows, cols, samples) integer view of one decoded tile/strip.
    # TIFF predictor 2 is a per-sample horizontal delta modulo 2^bits;
    # accumulate in the storage dtype so the wraparound is exact for any
    # integer width (uint8/uint16/...).
    return np.add.accumulate(arr, axis=1, dtype=arr.dtype)


# --- Reader -------------------------------------------------------------------


@dataclass
class TiffPage:
    """Metadata for one IFD (= one pyramid level in our files)."""

    width: int
    height: int
    bits: int = 8
    compression: int = COMPRESSION_NONE
    photometric: int = PHOTOMETRIC_MINISBLACK
    samples: int = 1
    sample_format: int = SAMPLEFORMAT_UINT
    predictor: int = 1
    tile_width: int = 0
    tile_height: int = 0
    tile_offsets: Sequence[int] = field(default_factory=list)
    tile_counts: Sequence[int] = field(default_factory=list)
    rows_per_strip: int = 0
    strip_offsets: Sequence[int] = field(default_factory=list)
    strip_counts: Sequence[int] = field(default_factory=list)
    jpeg_tables: Optional[bytes] = None
    description: str = ""
    x_resolution: float = 0.0
    resolution_unit: int = 2  # 2=inch, 3=cm
    byte_order: str = "<"
    tag_ids: frozenset = frozenset()  # all tag ids present in the IFD
    lazy_tags: dict = field(default_factory=dict)  # tag -> (ftype, count, value_field)
    ndpi: dict = field(default_factory=dict)       # NDPI private tag values
    xmp: bytes = b""          # tag 700 packet (Ventana iScan XML)
    sparse_fill: int = 0      # fill value for absent tiles (offset/count 0);
    # Philips TIFF omits background tiles and defines them as white

    @property
    def is_tiled(self) -> bool:
        return self.tile_width > 0

    @property
    def dtype(self) -> np.dtype:
        bo = self.byte_order
        if self.sample_format == SAMPLEFORMAT_FLOAT:
            return np.dtype(bo + ("f4" if self.bits == 32 else "f8"))
        if self.bits == 8:
            return np.dtype(np.uint8)
        if self.bits == 16:
            return np.dtype(bo + "u2")
        if self.bits == 32:
            return np.dtype(bo + "u4")
        raise ValueError(f"unsupported bits per sample: {self.bits}")

    @property
    def tiles_across(self) -> int:
        return (self.width + self.tile_width - 1) // self.tile_width

    @property
    def tiles_down(self) -> int:
        return (self.height + self.tile_height - 1) // self.tile_height


class TiffReader:
    """Random-access reader for (pyramidal) TIFF files.

    Thread safe: region reads use ``os.pread`` (no shared file-position
    state), so the host patch loader can fan out across threads.
    """

    def __init__(self, path: str, tile_cache_size: int = 64):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        self._fsize = os.fstat(self._fd).st_size
        self._cache_lock = threading.Lock()
        self._tile_cache: "OrderedDict[Tuple[int, int], np.ndarray]" = OrderedDict()
        self._tile_cache_size = tile_cache_size
        self.pages: List[TiffPage] = []
        try:
            self._parse()
        except BaseException:
            self.close()  # don't leak the fd when rejecting a corrupt file
            raise

    # -- low-level --------------------------------------------------------

    def _pread(self, offset: int, size: int) -> bytes:
        # Bound-check against the file size BEFORE allocating: a corrupt
        # count field can claim terabytes, and os.pread allocates the whole
        # buffer up front (tests/test_corrupt_inputs.py).
        if size < 0 or offset < 0 or offset + size > self._fsize:
            raise IOError(
                f"{self.path}: read [{offset}, {offset + size}) outside the "
                f"{self._fsize}-byte file (corrupt offset/count)")
        data = os.pread(self._fd, size, offset)
        if len(data) != size:
            raise IOError(f"short read at {offset} ({len(data)}/{size} bytes)")
        return data

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):  # last-reference safety net (cache eviction relies on it)
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- parsing ----------------------------------------------------------

    def _parse(self):
        header = self._pread(0, 16)
        order = header[:2]
        if order == II:
            self._bo = "<"
        elif order == MM:
            self._bo = ">"
        else:
            raise ValueError(f"{self.path}: not a TIFF file")
        magic = struct.unpack(self._bo + "H", header[2:4])[0]
        if magic == 42:
            self._big = False
            ifd_offset = struct.unpack(self._bo + "I", header[4:8])[0]
        elif magic == 43:
            self._big = True
            offsize, _ = struct.unpack(self._bo + "HH", header[4:8])
            if offsize != 8:
                raise ValueError("unsupported BigTIFF offset size")
            ifd_offset = struct.unpack(self._bo + "Q", header[8:16])[0]
        else:
            raise ValueError(f"{self.path}: bad TIFF magic {magic}")

        seen = set()
        while ifd_offset and ifd_offset not in seen:
            seen.add(ifd_offset)
            try:
                page, ifd_offset = self._parse_ifd(ifd_offset)
            except (ValueError, OSError):
                raise
            except Exception as e:
                # Parser boundary for untrusted bytes: whatever a corrupt
                # IFD trips inside (struct.error, TypeError from a missing
                # tag, IndexError, ...) surfaces as the documented reader
                # contract — ValueError/OSError only (io/slide.py:380
                # catches exactly these; tests/test_corrupt_inputs.py).
                raise ValueError(
                    f"{self.path}: corrupt TIFF structure in IFD at "
                    f"{ifd_offset}: {e!r}") from e
            self.pages.append(page)
        if not self.pages:
            raise ValueError(f"{self.path}: TIFF contains no images")

    def _parse_ifd(self, offset: int) -> Tuple[TiffPage, int]:
        bo = self._bo
        if self._big:
            n = struct.unpack(bo + "Q", self._pread(offset, 8))[0]
            entry_size, count_fmt, base = 20, "Q", offset + 8
        else:
            n = struct.unpack(bo + "H", self._pread(offset, 2))[0]
            entry_size, count_fmt, base = 12, "I", offset + 2
        raw = self._pread(base, n * entry_size)
        tags = {}
        lazy = {}
        for i in range(n):
            e = raw[i * entry_size:(i + 1) * entry_size]
            tag, ftype = struct.unpack(bo + "HH", e[:4])
            count = struct.unpack(bo + count_fmt, e[4:4 + struct.calcsize(count_fmt)])[0]
            value_field = e[4 + struct.calcsize(count_fmt):]
            if tag in _LAZY_TAGS:
                # e.g. NDPI McuStarts (65426): one entry per restart segment
                # — hundreds of MB on gigapixel levels. Defer to
                # read_lazy_tag() so parsing/IFD scans stay O(header).
                lazy[tag] = (ftype, count, bytes(value_field))
                continue
            tags[tag] = self._read_tag_values(ftype, count, value_field)
        next_off_pos = base + n * entry_size
        if self._big:
            next_ifd = struct.unpack(bo + "Q", self._pread(next_off_pos, 8))[0]
        else:
            next_ifd = struct.unpack(bo + "I", self._pread(next_off_pos, 4))[0]

        def one(tag, default=None):
            v = tags.get(tag)
            if v is None:
                return default
            return v[0] if isinstance(v, (list, tuple)) else v

        bits = tags.get(TAG_BITS_PER_SAMPLE, [8])
        w, h = one(TAG_IMAGE_WIDTH), one(TAG_IMAGE_LENGTH)
        if not w or not h or int(w) < 0 or int(h) < 0:
            raise ValueError(f"{self.path}: IFD at {offset} has missing or "
                             f"invalid image dimensions ({w!r} x {h!r})")
        page = TiffPage(
            width=int(w),
            height=int(h),
            bits=int(bits[0] if isinstance(bits, (list, tuple)) else bits),
            compression=int(one(TAG_COMPRESSION, COMPRESSION_NONE)),
            photometric=int(one(TAG_PHOTOMETRIC, PHOTOMETRIC_MINISBLACK)),
            samples=int(one(TAG_SAMPLES_PER_PIXEL, 1)),
            sample_format=int(one(TAG_SAMPLE_FORMAT, SAMPLEFORMAT_UINT)),
            predictor=int(one(TAG_PREDICTOR, 1)),
            tile_width=int(one(TAG_TILE_WIDTH, 0)),
            tile_height=int(one(TAG_TILE_LENGTH, 0)),
            tile_offsets=list(tags.get(TAG_TILE_OFFSETS, [])),
            tile_counts=list(tags.get(TAG_TILE_BYTE_COUNTS, [])),
            rows_per_strip=int(one(TAG_ROWS_PER_STRIP, 0)),
            strip_offsets=list(tags.get(TAG_STRIP_OFFSETS, [])),
            strip_counts=list(tags.get(TAG_STRIP_BYTE_COUNTS, [])),
            jpeg_tables=bytes(tags[TAG_JPEG_TABLES]) if TAG_JPEG_TABLES in tags else None,
            description=(
                bytes(tags[TAG_IMAGE_DESCRIPTION]).split(b"\0")[0].decode("utf-8", "replace")
                if TAG_IMAGE_DESCRIPTION in tags else ""
            ),
            x_resolution=float(one(TAG_X_RESOLUTION, 0.0) or 0.0),
            resolution_unit=int(one(TAG_RESOLUTION_UNIT, 2)),
            byte_order=self._bo,
        )
        # Structural sanity (corrupt-file contract, tests/test_corrupt_inputs):
        # a tiled page needs BOTH tile dims; offset/count tables come in pairs
        # of equal length (otherwise region reads would index past one).
        if (page.tile_width > 0) != (page.tile_height > 0):
            raise ValueError(f"{self.path}: IFD at {offset} has tile width "
                             f"{page.tile_width} x length {page.tile_height}")
        if page.is_tiled and len(page.tile_offsets) != len(page.tile_counts):
            raise ValueError(
                f"{self.path}: tile offset/count tables disagree "
                f"({len(page.tile_offsets)} vs {len(page.tile_counts)})")
        if (not page.is_tiled and page.strip_offsets
                and len(page.strip_offsets) != len(page.strip_counts)):
            raise ValueError(
                f"{self.path}: strip offset/count tables disagree "
                f"({len(page.strip_offsets)} vs {len(page.strip_counts)})")
        if not 1 <= page.samples <= 64:
            raise ValueError(
                f"{self.path}: implausible SamplesPerPixel {page.samples}")
        page.tag_ids = frozenset(tags) | frozenset(lazy)  # format sniffing
        page.lazy_tags = lazy
        if TAG_XMP in tags:
            page.xmp = bytes(tags[TAG_XMP])
        # Hamamatsu NDPI private tags (io/ndpi.py): SourceLens (65421,
        # magnification; -1 macro, -2 map) and the lens offsets.
        page.ndpi = {t: tags[t] for t in (65420, 65421, 65422, 65423)
                     if t in tags}
        return page, next_ifd

    def read_lazy_tag(self, page: TiffPage, tag: int):
        """Parse a deferred big-array tag (see ``_LAZY_TAGS``) into a numpy
        array (these tables can hold millions of offsets), or None."""
        spec = page.lazy_tags.get(tag)
        if spec is None:
            return None
        ftype, count, value_field = spec
        if ftype not in _TYPE_INFO:
            return None
        ch, size = _TYPE_INFO[ftype]
        if len(ch) != 1:  # rationals etc. are never lazy
            return np.asarray(self._read_tag_values(ftype, count, value_field))
        total = size * count
        inline_cap = 8 if self._big else 4
        if total <= inline_cap:
            data = value_field[:total]
        else:
            off_fmt = "Q" if self._big else "I"
            off = struct.unpack(
                self._bo + off_fmt, value_field[:struct.calcsize(off_fmt)])[0]
            data = self._pread(off, total)
        return np.frombuffer(data, dtype=np.dtype(self._bo + ch)).copy()

    def _read_tag_values(self, ftype: int, count: int, value_field: bytes):
        bo = self._bo
        if ftype not in _TYPE_INFO:
            return []
        ch, size = _TYPE_INFO[ftype]
        total = size * count
        inline_cap = 8 if self._big else 4
        if total <= inline_cap:
            data = value_field[:total]
        else:
            off_fmt = "Q" if self._big else "I"
            off = struct.unpack(bo + off_fmt, value_field[:struct.calcsize(off_fmt)])[0]
            data = self._pread(off, total)
        if ftype in (2, 7, 1, 6):  # ASCII / UNDEFINED / bytes
            return data
        if ftype in (5, 10):  # rationals -> floats
            vals = struct.unpack(bo + ch * count, data)
            return [vals[2 * i] / max(vals[2 * i + 1], 1) for i in range(count)]
        return list(struct.unpack(bo + ch * count, data))

    # -- decoding ---------------------------------------------------------

    def _decode_block(self, page: TiffPage, data: bytes, block_h: int, block_w: int) -> np.ndarray:
        try:
            return self._decode_block_impl(page, data, block_h, block_w)
        except (ValueError, OSError):
            raise
        except Exception as e:
            # Decoder boundary for untrusted bytes (same contract as the
            # IFD parser): zlib.error, PIL decode errors, reshape failures
            # on corrupt payloads all surface as ValueError.
            raise ValueError(
                f"{self.path}: corrupt block payload "
                f"(compression {page.compression}): {e!r}") from e

    def _decode_block_impl(self, page: TiffPage, data: bytes, block_h: int, block_w: int) -> np.ndarray:
        comp = page.compression
        if comp == COMPRESSION_JPEG:
            stream = data
            if page.jpeg_tables and len(page.jpeg_tables) > 4:
                # Abbreviated stream: splice shared tables after the tile's SOI.
                stream = data[:2] + page.jpeg_tables[2:-2] + data[2:]
            from PIL import Image

            img = Image.open(io.BytesIO(stream))
            if page.samples >= 3:
                img = img.convert("RGB")
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            # JPEG blocks may come back padded to MCU multiples; crop below.
            return arr[:block_h, :block_w, :page.samples if page.samples <= arr.shape[2] else arr.shape[2]]

        if comp in (COMPRESSION_APERIO_J2K_YCBCR, COMPRESSION_APERIO_J2K_RGB):
            # Aperio SVS JPEG2000: each tile is a raw J2K codestream
            # (reference capability via OpenSlide at main_server.py:54-55).
            from PIL import Image, features

            if not features.check("jpg_2000"):
                raise ValueError(
                    "JPEG2000-compressed SVS needs Pillow with OpenJPEG "
                    "support (feature 'jpg_2000' unavailable)")
            img = Image.open(io.BytesIO(data))
            arr = np.asarray(img.convert("RGB") if page.samples >= 3 else img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if comp == COMPRESSION_APERIO_J2K_YCBCR and arr.shape[2] == 3 \
                    and img.mode == "RGB":
                # 33003 codestreams usually carry no colorspace box: OpenJPEG
                # hands back the raw YCbCr planes as if RGB. Undo with the
                # full-range BT.601 transform (what OpenSlide does).
                ycc = arr.astype(np.float32)
                y, cb, cr = ycc[..., 0], ycc[..., 1] - 128, ycc[..., 2] - 128
                arr = np.stack([
                    y + 1.402 * cr,
                    y - 0.344136 * cb - 0.714136 * cr,
                    y + 1.772 * cb,
                ], axis=-1)
                arr = np.clip(arr, 0, 255).astype(np.uint8)
            return arr[:block_h, :block_w]

        if page.photometric == PHOTOMETRIC_PALETTE:
            raise ValueError(
                "palette-color TIFFs are not supported (indices would be "
                "silently misread as intensities)")
        if page.photometric == PHOTOMETRIC_YCBCR:
            raise ValueError(
                "YCbCr without JPEG compression is not supported")
        dtype = page.dtype
        # Cap decompression at the size the block geometry implies: deflate
        # expands ~1000x and LZW ~2700x, so without a bound a KB-sized
        # corrupt block could balloon to GBs (tests/test_corrupt_inputs.py).
        expected = block_h * block_w * page.samples * dtype.itemsize
        if comp in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
            raw = zlib.decompressobj().decompress(data, expected)
        elif comp == COMPRESSION_LZW:
            raw = lzw_decode(data, max_out=expected)
        elif comp == COMPRESSION_NONE:
            raw = data
        else:
            raise ValueError(f"unsupported TIFF compression {comp}")
        arr = np.frombuffer(raw, dtype=dtype, count=block_h * block_w * page.samples)
        arr = arr.reshape(block_h, block_w, page.samples)
        if page.predictor == 2:
            if not np.issubdtype(dtype, np.integer):
                raise ValueError(
                    f"horizontal predictor on non-integer dtype {dtype} is "
                    "not supported")
            arr = _undo_horizontal_predictor(arr)
        elif page.predictor not in (0, 1):
            raise ValueError(
                f"unsupported TIFF predictor {page.predictor} "
                "(only none/horizontal)")
        if page.photometric == PHOTOMETRIC_MINISWHITE:
            mx = 255 if dtype == np.uint8 else (1 << page.bits) - 1
            arr = (mx - arr).astype(arr.dtype)
        return arr

    def _tile(self, level: int, idx: int) -> np.ndarray:
        key = (level, idx)
        with self._cache_lock:
            cached = self._tile_cache.get(key)
            if cached is not None:
                self._tile_cache.move_to_end(key)
                return cached
        page = self.pages[level]
        if idx >= len(page.tile_offsets):
            raise ValueError(
                f"{self.path}: tile {idx} outside the level-{level} tile "
                f"table ({len(page.tile_offsets)} entries; corrupt file?)")
        if not page.tile_offsets[idx] or not page.tile_counts[idx]:
            # Sparse tile (Philips TIFF drops background tiles: offset and
            # byte count 0); render as the format's background color.
            arr = np.full((page.tile_height, page.tile_width, page.samples),
                          page.sparse_fill, page.dtype)
        else:
            data = self._pread(page.tile_offsets[idx], page.tile_counts[idx])
            arr = self._decode_block(page, data, page.tile_height,
                                     page.tile_width)
        if arr.shape[:2] != (page.tile_height, page.tile_width):
            full = np.zeros((page.tile_height, page.tile_width, arr.shape[2]), arr.dtype)
            full[:arr.shape[0], :arr.shape[1]] = arr
            arr = full
        with self._cache_lock:
            self._tile_cache[key] = arr
            while len(self._tile_cache) > self._tile_cache_size:
                self._tile_cache.popitem(last=False)
        return arr

    def read_whole(self, level: int) -> np.ndarray:
        page = self.pages[level]
        return self.read_region(level, 0, 0, page.width, page.height)

    def read_region(self, level: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Read a (h, w, samples) region; ``x, y`` are in this level's pixels.

        Out-of-bounds areas are zero-filled (matching the reference's
        ``read_region(...).convert('RGB')`` behavior on OOB, which yields
        black; cf. ``reference DigiPathAI/loaders/dataloader.py:357``).
        """
        page = self.pages[level]
        out = np.zeros((h, w, page.samples), dtype=page.dtype)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, page.width), min(y + h, page.height)
        if x0 >= x1 or y0 >= y1:
            return out

        if page.is_tiled:
            tw, th = page.tile_width, page.tile_height
            ta = page.tiles_across
            for ty in range(y0 // th, (y1 - 1) // th + 1):
                for tx in range(x0 // tw, (x1 - 1) // tw + 1):
                    tile = self._tile(level, ty * ta + tx)
                    # Intersection of tile with the requested region
                    ix0, iy0 = max(x0, tx * tw), max(y0, ty * th)
                    ix1, iy1 = min(x1, (tx + 1) * tw), min(y1, (ty + 1) * th)
                    out[iy0 - y:iy1 - y, ix0 - x:ix1 - x] = tile[
                        iy0 - ty * th:iy1 - ty * th, ix0 - tx * tw:ix1 - tx * tw
                    ]
        else:
            rps = page.rows_per_strip or page.height
            for s in range(y0 // rps, (y1 - 1) // rps + 1):
                if s >= len(page.strip_offsets):
                    raise ValueError(
                        f"{self.path}: strip {s} outside the level-{level} "
                        f"strip table ({len(page.strip_offsets)} entries; "
                        "corrupt file?)")
                sh = min(rps, page.height - s * rps)
                data = self._pread(page.strip_offsets[s], page.strip_counts[s])
                strip = self._decode_block(page, data, sh, page.width)
                iy0, iy1 = max(y0, s * rps), min(y1, s * rps + sh)
                out[iy0 - y:iy1 - y, x0 - x:x1 - x] = strip[iy0 - s * rps:iy1 - s * rps, x0:x1]
        return out


# --- Writer -------------------------------------------------------------------


def _encode_tile(tile: np.ndarray, compression: str, quality: int) -> bytes:
    if compression == "deflate":
        return zlib.compress(np.ascontiguousarray(tile).tobytes(), 6)
    if compression == "jpeg":
        from PIL import Image

        arr = tile if tile.ndim == 2 or tile.shape[2] > 1 else tile[:, :, 0]
        img = Image.fromarray(arr)
        buf = io.BytesIO()
        img.save(buf, "jpeg", quality=quality)
        return buf.getvalue()
    if compression in ("j2k", "j2k-ycbcr"):
        # Aperio-convention raw JPEG2000 codestreams (33005 RGB / 33003
        # YCbCr).  The YCbCr flavor stores the transformed planes as raw
        # components, matching what OpenJPEG returns for real 33003 tiles.
        from PIL import Image

        arr = tile if tile.ndim == 2 or tile.shape[2] > 1 else tile[:, :, 0]
        if compression == "j2k-ycbcr" and arr.ndim == 3 and arr.shape[2] == 3:
            rgb = arr.astype(np.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            arr = np.clip(np.stack([
                0.299 * r + 0.587 * g + 0.114 * b,
                128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                128 + 0.5 * r - 0.418688 * g - 0.081312 * b,
            ], axis=-1), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG2000", no_jp2=True)  # lossless
        return buf.getvalue()
    if compression == "raw":
        return np.ascontiguousarray(tile).tobytes()
    raise ValueError(f"unknown compression {compression!r}")


_COMP_TAG = {"deflate": COMPRESSION_DEFLATE_ADOBE, "jpeg": COMPRESSION_JPEG,
             "raw": COMPRESSION_NONE, "j2k": COMPRESSION_APERIO_J2K_RGB,
             "j2k-ycbcr": COMPRESSION_APERIO_J2K_YCBCR}


class _IfdBuilder:
    """Accumulates (tag, type, values) and serializes a little-endian IFD."""

    def __init__(self, big: bool = False):
        self.entries = []
        self.big = big

    def add(self, tag, ftype, values):
        if not isinstance(values, (list, tuple, bytes)):
            values = [values]
        self.entries.append((tag, ftype, values))

    def write(self, f) -> int:
        """Write IFD at current position; returns file offset of next-IFD ptr."""
        self.entries.sort(key=lambda e: e[0])
        n = len(self.entries)
        ifd_offset = f.tell()
        if self.big:
            entry_size, header_size, ptr_size = 20, 8, 8
        else:
            entry_size, header_size, ptr_size = 12, 2, 4
        table_size = header_size + n * entry_size + ptr_size
        data_offset = ifd_offset + table_size
        table = io.BytesIO()
        if self.big:
            table.write(struct.pack("<Q", n))
        else:
            table.write(struct.pack("<H", n))
        blobs = []
        inline_cap = 8 if self.big else 4
        cnt_fmt = "<Q" if self.big else "<I"
        for tag, ftype, values in self.entries:
            ch, size = _TYPE_INFO[ftype]
            if isinstance(values, bytes):
                payload, count = values, len(values)
            elif ftype in (5, 10):
                payload = b"".join(struct.pack("<" + ch, *v) for v in values)
                count = len(values)
            else:
                payload = struct.pack("<" + ch * len(values), *values)
                count = len(values)
            table.write(struct.pack("<HH", tag, ftype))
            table.write(struct.pack(cnt_fmt, count))
            if len(payload) <= inline_cap:
                table.write(payload.ljust(inline_cap, b"\0"))
            else:
                if len(payload) % 2:
                    payload += b"\0"
                table.write(struct.pack(cnt_fmt, data_offset))
                blobs.append(payload)
                data_offset += len(payload)
        next_ptr_pos = ifd_offset + header_size + n * entry_size
        table.write(struct.pack(cnt_fmt, 0))  # next IFD (patched later)
        f.write(table.getvalue())
        for b in blobs:
            f.write(b)
        return next_ptr_pos


class PyramidalTiffWriter:
    """Streams a tiled pyramidal TIFF without materializing all levels in RAM.

    Usage::

        with PyramidalTiffWriter(path, w, h, channels=3) as wr:
            wr.write_base(source)   # source: array-like supporting 2D slicing
        # levels are generated by 2x2 mean downsampling until <= tile size

    Equivalent artifact to the reference's ``tifffile.imsave`` + ImageMagick
    ``convert ... ptif:`` two-step (``reference Segmentation.py:333-352``),
    produced directly with no subprocess and no intermediate flat TIFF.
    """

    def __init__(self, path, width, height, channels=1, dtype=np.uint8,
                 tile=256, compression="jpeg", quality=90, description="",
                 mpp=None, bigtiff=None, scratch_dir=None):
        self.path = str(path)
        self.width, self.height, self.channels = int(width), int(height), int(channels)
        self.dtype = np.dtype(dtype)
        if self.dtype == np.float32 and compression == "jpeg":
            compression = "deflate"
        self.tile = int(tile)
        self.compression = compression
        self.quality = quality
        self.description = description
        self.mpp = mpp
        self.scratch_dir = scratch_dir
        if bigtiff is None:
            # Heuristic: raw base size over ~2 GB -> BigTIFF offsets.
            bigtiff = width * height * channels * self.dtype.itemsize > (2 << 30)
        self.big = bool(bigtiff)
        self._levels_meta = []  # (w, h, offsets, counts)
        self._f = open(self.path, "wb")
        if self.big:
            self._f.write(struct.pack("<2sHHHQ", II, 43, 8, 0, 0))
        else:
            self._f.write(struct.pack("<2sHI", II, 42, 0))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finish()
        else:
            self._f.close()

    # -- level emission ---------------------------------------------------

    def _emit_level(self, source, w, h):
        """Write one level's tiles; returns (offsets, counts)."""
        t = self.tile
        offsets, counts = [], []
        for ty in range(0, h, t):
            bh = min(t, h - ty)
            # Read a full row-block of tiles at once (cheap for memmaps).
            block = np.asarray(source[ty:ty + bh, 0:w])
            if block.ndim == 2:
                block = block[:, :, None]
            for tx in range(0, w, t):
                bw = min(t, w - tx)
                tile_arr = np.zeros((t, t, self.channels), self.dtype)
                tile_arr[:bh, :bw] = block[:, tx:tx + bw]
                if self.compression == "jpeg":
                    # JPEG edge tiles: replicate edge pixels to avoid dark
                    # bleed from the zero padding into in-bounds pixels.
                    if bh < t:
                        tile_arr[bh:] = tile_arr[bh - 1:bh]
                    if bw < t:
                        tile_arr[:, bw:] = tile_arr[:, bw - 1:bw]
                data = _encode_tile(
                    tile_arr if self.channels > 1 else tile_arr[:, :, 0],
                    self.compression, self.quality,
                )
                offsets.append(self._f.tell())
                counts.append(len(data))
                self._f.write(data)
        return offsets, counts

    def _downsample_source(self, source, w, h):
        """2x2 mean downsample into RAM or a scratch memmap for huge levels."""
        nw, nh = max(1, w // 2), max(1, h // 2)
        nbytes = nw * nh * self.channels * self.dtype.itemsize
        if nbytes > (512 << 20):
            import tempfile

            tmp = tempfile.NamedTemporaryFile(
                prefix="dpai_pyr_", suffix=".dat", dir=self.scratch_dir, delete=False)
            shape = (nh, nw, self.channels) if self.channels > 1 else (nh, nw)
            dst = np.memmap(tmp.name, dtype=self.dtype, mode="w+", shape=shape)
            self._scratch_files.append(tmp.name)
        else:
            shape = (nh, nw, self.channels) if self.channels > 1 else (nh, nw)
            dst = np.zeros(shape, self.dtype)
        step = 4096
        for y in range(0, nh, step):
            bh = min(step, nh - y)
            block = np.asarray(source[2 * y:2 * (y + bh), 0:2 * nw])
            if block.ndim == 2:
                block = block[:, :, None]
            blk = block.reshape(bh, 2, nw, 2, self.channels).astype(np.float32)
            ds = blk.mean(axis=(1, 3))
            if np.issubdtype(self.dtype, np.integer):
                ds = np.round(ds)
            view = dst[y:y + bh]
            view_3d = view if view.ndim == 3 else view[:, :, None]
            view_3d[:] = ds.astype(self.dtype)
        return dst, nw, nh

    def write_base(self, source):
        """Write level 0 from ``source`` and derive all coarser levels."""
        self._scratch_files = []
        w, h = self.width, self.height
        offsets, counts = self._emit_level(source, w, h)
        self._levels_meta.append((w, h, offsets, counts))
        cur = source
        while max(w, h) > self.tile:
            cur, w, h = self._downsample_source(cur, w, h)
            offsets, counts = self._emit_level(cur, w, h)
            self._levels_meta.append((w, h, offsets, counts))

    # -- finalize ---------------------------------------------------------

    def _ifd_for_level(self, idx) -> _IfdBuilder:
        w, h, offsets, counts = self._levels_meta[idx]
        b = _IfdBuilder(big=self.big)
        off_type = 16 if self.big else 4
        b.add(TAG_IMAGE_WIDTH, 4, w)
        b.add(TAG_IMAGE_LENGTH, 4, h)
        b.add(TAG_BITS_PER_SAMPLE, 3, [self.dtype.itemsize * 8] * self.channels)
        b.add(TAG_COMPRESSION, 3, _COMP_TAG[self.compression])
        if self.channels >= 3:
            b.add(TAG_PHOTOMETRIC, 3,
                  PHOTOMETRIC_YCBCR if self.compression == "jpeg" else PHOTOMETRIC_RGB)
        else:
            b.add(TAG_PHOTOMETRIC, 3, PHOTOMETRIC_MINISBLACK)
        b.add(TAG_SAMPLES_PER_PIXEL, 3, self.channels)
        b.add(TAG_PLANAR_CONFIG, 3, 1)
        b.add(TAG_TILE_WIDTH, 3, self.tile)
        b.add(TAG_TILE_LENGTH, 3, self.tile)
        b.add(TAG_TILE_OFFSETS, off_type, offsets)
        b.add(TAG_TILE_BYTE_COUNTS, 4, counts)
        if np.issubdtype(self.dtype, np.floating):
            b.add(TAG_SAMPLE_FORMAT, 3, [SAMPLEFORMAT_FLOAT] * self.channels)
        if idx == 0:
            desc = self.description or ""
            if self.mpp:
                desc = (desc + "|" if desc else "") + f"mpp={self.mpp}"
            if desc:
                b.add(TAG_IMAGE_DESCRIPTION, 2, desc.encode() + b"\0")
            if self.mpp:
                # pixels per cm
                ppcm = 10000.0 / float(self.mpp)
                frac = (int(ppcm * 1000), 1000)
                b.add(TAG_X_RESOLUTION, 5, [frac])
                b.add(TAG_Y_RESOLUTION, 5, [frac])
                b.add(TAG_RESOLUTION_UNIT, 3, 3)  # centimeter
        return b

    def finish(self):
        f = self._f
        prev_ptr_pos = 4 if not self.big else 8
        for i in range(len(self._levels_meta)):
            if f.tell() % 2:
                f.write(b"\0")
            ifd_offset = f.tell()
            next_ptr_pos = self._ifd_for_level(i).write(f)
            end = f.tell()
            f.seek(prev_ptr_pos)
            f.write(struct.pack("<Q" if self.big else "<I", ifd_offset))
            f.seek(end)
            prev_ptr_pos = next_ptr_pos
        f.close()
        for tmp in getattr(self, "_scratch_files", []):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def write_pyramidal_tiff(path, array, tile=256, compression="jpeg", quality=90,
                         description="", mpp=None, scratch_dir=None):
    """Write ``array`` (H, W) or (H, W, C) as a tiled pyramidal TIFF."""
    array = np.asarray(array) if not isinstance(array, np.memmap) else array
    h, w = array.shape[:2]
    channels = array.shape[2] if array.ndim == 3 else 1
    with PyramidalTiffWriter(path, w, h, channels=channels, dtype=array.dtype,
                             tile=tile, compression=compression, quality=quality,
                             description=description, mpp=mpp,
                             scratch_dir=scratch_dir) as wr:
        wr.write_base(array)
    return path
