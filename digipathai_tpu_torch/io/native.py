"""ctypes binding for the C++ libtiff backend (digipathai_tpu_torch/native).

Same interface as ``tiff_py.TiffReader`` / ``write_pyramidal_tiff`` so
``backend.open_tiff`` can swap implementations transparently.  Build with
``make -C digipathai_tpu_torch/native``; auto-builds on first use if a compiler is
available (set ``DPAI_NATIVE=0`` to opt out entirely).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from dataclasses import dataclass
from typing import List

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
# built on first use into the git-ignored build/ directory of the port
_SO = os.path.abspath(os.path.join(_DIR, "build", "libdpai_tiff.so"))

_lib = None
_lib_lock = threading.Lock()
_COMP = {"raw": 1, "lzw": 5, "jpeg": 7, "deflate": 8}


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO):
            try:
                subprocess.run(["make", "-C", os.path.abspath(_DIR), "-s"],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"native build failed: {e}") from e
        lib = ctypes.CDLL(_SO)
        lib.dpai_open.restype = ctypes.c_void_p
        lib.dpai_open.argtypes = [ctypes.c_char_p]
        lib.dpai_close.argtypes = [ctypes.c_void_p]
        lib.dpai_level_count.argtypes = [ctypes.c_void_p]
        lib.dpai_level_count.restype = ctypes.c_int
        lib.dpai_level_info.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_uint32)]
        lib.dpai_level_info.restype = ctypes.c_int
        lib.dpai_description.argtypes = [ctypes.c_void_p]
        lib.dpai_description.restype = ctypes.c_char_p
        lib.dpai_resolution.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.dpai_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)]
        lib.dpai_read_region.restype = ctypes.c_int
        lib.dpai_write_pyramid.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_double]
        lib.dpai_write_pyramid.restype = ctypes.c_int
        lib.dpai_set_cache_size.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.dpai_set_cache_size.restype = None
        if hasattr(lib, "dpai_writer_open"):
            lib.dpai_writer_open.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_double]
            lib.dpai_writer_open.restype = ctypes.c_void_p
            lib.dpai_writer_write_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint32]
            lib.dpai_writer_write_rows.restype = ctypes.c_int
            lib.dpai_writer_close.argtypes = [ctypes.c_void_p]
            lib.dpai_writer_close.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


@dataclass
class _Page:
    width: int
    height: int
    tile_width: int
    tile_height: int
    samples: int
    bits: int
    description: str = ""
    sample_format: int = 1
    x_resolution: float = 0.0
    resolution_unit: int = 2
    compression: int = 0
    photometric: int = 0


class NativeTiffReader:
    """libtiff-backed reader; always returns 3-channel uint8 regions."""

    def __init__(self, path: str, tile_cache_size: int = 0):
        lib = _load()
        self._lib = lib
        self._h = lib.dpai_open(str(path).encode())
        if not self._h:
            raise ValueError(f"{path}: not a TIFF file (native open failed)")
        if tile_cache_size:
            lib.dpai_set_cache_size(self._h, int(tile_cache_size))
        n = lib.dpai_level_count(self._h)
        desc = (lib.dpai_description(self._h) or b"").decode("utf-8", "replace")
        xres = ctypes.c_float(0.0)
        unit = ctypes.c_int(2)
        lib.dpai_resolution(self._h, ctypes.byref(xres), ctypes.byref(unit))
        self.pages: List[_Page] = []
        info = (ctypes.c_uint32 * 8)()
        info2 = getattr(lib, "dpai_level_info2", None)
        ldesc = getattr(lib, "dpai_level_description", None)
        if info2 is not None:
            info2.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint32)]
            info2.restype = ctypes.c_int
        if ldesc is not None:
            ldesc.argtypes = [ctypes.c_void_p, ctypes.c_int]
            ldesc.restype = ctypes.c_char_p
        for i in range(n):
            if info2 is not None:
                info2(self._h, i, info)
            else:  # stale .so predating info2: compression unknown (0)
                lib.dpai_level_info(self._h, i, info)
                info[6] = info[7] = 0
            page_desc = ((ldesc(self._h, i) or b"").decode("utf-8", "replace")
                         if ldesc is not None else (desc if i == 0 else ""))
            self.pages.append(_Page(
                width=int(info[0]), height=int(info[1]),
                tile_width=int(info[2]), tile_height=int(info[3]),
                samples=3, bits=int(info[5]),
                description=page_desc,
                x_resolution=float(xres.value) if i == 0 else 0.0,
                resolution_unit=int(unit.value),
                compression=int(info[6]), photometric=int(info[7])))

    def read_region(self, level: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.dpai_read_region(
            self._h, level, int(x), int(y), int(w), int(h),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native read_region failed (rc={rc})")
        return out

    def read_whole(self, level: int) -> np.ndarray:
        p = self.pages[level]
        return self.read_region(level, 0, 0, p.width, p.height)

    def close(self):
        if self._h:
            self._lib.dpai_close(self._h)
            self._h = None

    def __del__(self):  # last-reference safety net (cache eviction relies on it)
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativePyramidWriter:
    """Streaming row-block pyramid writer (C++ cascade; O(strip) RAM).

    Feed level-0 rows top-to-bottom via ``write_rows``; downsample levels
    stream through per-level disk scratch so gigapixel maps never
    materialize in memory (the role ImageMagick ``ptif:`` plays in the
    reference, ``Segmentation.py:333-352``, minus the full-image buffering).
    """

    def __init__(self, path, width, height, channels=1, tile=256,
                 compression="jpeg", quality=90, description="", mpp=None):
        lib = _load()
        if not hasattr(lib, "dpai_writer_open"):
            raise NotImplementedError("native library predates the streaming "
                                      "writer; rebuild digipathai_tpu_torch/native")
        self._lib = lib
        self.width, self.channels = int(width), int(channels)
        self._h = lib.dpai_writer_open(
            str(path).encode(), int(width), int(height), int(channels),
            int(tile), _COMP[compression], int(quality),
            (description or "").encode(), float(mpp or 0.0))
        if not self._h:
            raise IOError(f"native writer open failed for {path}")

    def write_rows(self, rows: np.ndarray):
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if rows.ndim == 2:
            rows = rows[:, :, None]
        assert rows.shape[1] == self.width and rows.shape[2] == self.channels
        rc = self._lib.dpai_writer_write_rows(
            self._h, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rows.shape[0])
        if rc != 0:
            raise IOError(f"native writer write_rows failed (rc={rc})")

    def close(self):
        if self._h:
            rc = self._lib.dpai_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(f"native writer close failed (rc={rc})")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        elif self._h:  # error path: finalize best-effort, keep original error
            try:
                self._lib.dpai_writer_close(self._h)
            finally:
                self._h = None


def write_pyramidal_tiff(path, array, tile=256, compression="jpeg",
                         quality=90, description="", mpp=None,
                         scratch_dir=None):
    """Write (H, W[, C]) uint8 as a tiled pyramid, streamed in row blocks
    (memmap-friendly: never copies the whole base level into RAM)."""
    if array.dtype != np.uint8:
        raise NotImplementedError("native writer handles uint8 only")
    h, w = array.shape[:2]
    channels = array.shape[2] if array.ndim == 3 else 1
    if channels not in (1, 3):
        raise NotImplementedError(f"native writer: {channels} channels")
    block = max(tile, (64 << 20) // max(1, w * channels))  # ~64 MB blocks
    with NativePyramidWriter(path, w, h, channels=channels, tile=tile,
                             compression=compression, quality=quality,
                             description=description, mpp=mpp) as wr:
        for y0 in range(0, h, block):
            wr.write_rows(array[y0:y0 + block])
    return path
