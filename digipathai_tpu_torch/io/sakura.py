"""Sakura SVSLIDE (.svslide) slide reader.

The reference opens SVSLIDE through OpenSlide's ``sakura`` driver
(``reference DigiPathAI/main_server.py:54-55`` — any format
``OpenSlide.detect_format`` accepts).  An SVSLIDE file is a plain SQLite 3
database; the layout implemented here follows the OpenSlide driver's
documented structure:

- ``DataManagerSQLiteConfigXPO``: one row whose ``TableName`` column names
  the blob table that holds the tile data.
- the tile table: rows of ``(id TEXT, data BLOB)``.  Tile ids encode the
  tile's position, focal plane, color channel, and zoom (downsample) as
  ``"x|y|focal|color|zoom"`` with ``x``/``y`` in level-0 pixels and ``zoom``
  a power-of-two downsample.  Pixel data is JPEG: either one grayscale JPEG
  per color channel (``color`` ∈ {0, 1, 2} = R, G, B — Sakura scanners store
  channels separately) or a single combined RGB JPEG under ``color`` 0.
- ``SVHRScanDataXPO``: per-scan metadata — ``m_nImageWidth``,
  ``m_nImageHeight``, ``m_nTileWidth``, ``m_nTileHeight``, and
  ``m_ResolutionMmPerPix`` (millimetres per pixel → mpp × 1000).
- ``SVSlideDataXPO``: one row whose ``m_labelScan`` / ``m_overviewScan``
  columns reference ``SVScannedImageDataXPO`` rows (by ``OID``) holding the
  label / macro JPEGs in ``m_image``.

Pyramid levels are discovered from the set of zoom factors present in the
tile ids (missing intermediate zooms are fine); absent tiles render as
white, matching scanner background.

Caveat (documented in PARITY.md): no real SVSLIDE ships in this offline
environment, so the schema handling is validated against self-authored
fixtures (``tests/fixtures.py: make_sakura_slide``) that follow the layout
above, not against scanner output.  Queries are defensive: metadata tables
are optional, and both per-channel and combined-RGB tiles are accepted.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from io import BytesIO
from typing import Dict, Optional, Tuple

import numpy as np

_SQLITE_MAGIC = b"SQLite format 3\x00"


from .pageinfo import SyntheticPage as SakuraPage  # noqa: E402


class SakuraReader:
    def __init__(self, path: str):
        self.path = str(path)
        # read-only URI: never create or lock a slide file
        self._db = sqlite3.connect(
            f"file:{self.path}?mode=ro", uri=True, check_same_thread=False)
        # one connection shared by the engine's loader threads: serialize
        # blob fetches (JPEG decode — the expensive part — runs unlocked)
        self._db_lock = threading.Lock()
        try:
            self._parse_schema()
        except BaseException:
            # a corrupt-file reject must not leak the sqlite connection:
            # the server retries Slide(path) on every tile request for a
            # bad slide, and each leaked handle counts against the fd limit
            self._db.close()
            raise

    def _parse_schema(self) -> None:
        self._table = self._tile_table()
        meta = self._scan_metadata()
        self.width, self.height = meta["width"], meta["height"]
        self.tile_w, self.tile_h = meta["tile_w"], meta["tile_h"]
        if self.tile_w <= 0 or self.tile_h <= 0:
            # corrupt scan row (0 already defaults to 256; negatives would
            # corrupt the tile-grid math) — reader contract: ValueError
            raise ValueError(f"{self.path}: invalid Sakura tile size "
                             f"{self.tile_w}x{self.tile_h}")

        # discover zoom factors + occupied tiles from the id namespace
        self._tiles: Dict[int, set] = {}
        self._colors: Dict[str, int] = {}  # id prefix "x|y|focal" -> colors
        try:
            rows = self._db.execute(
                f'SELECT id FROM "{self._table}"').fetchall()
        except sqlite3.Error as e:
            # a truncated/garbled db can pass the magic check and still
            # fail here ("database disk image is malformed"); keep the
            # reader contract (tests/test_corrupt_inputs.py)
            raise ValueError(
                f"{self.path}: corrupt Sakura database: {e}") from e
        for (tid,) in rows:
            parts = str(tid).split("|")
            if len(parts) != 5:
                continue  # non-tile blob
            try:
                x, y, focal, color, zoom = (int(p) for p in parts)
            except ValueError:
                continue
            if focal != 0 or zoom <= 0:
                continue  # single focal plane only (OpenSlide does the same)
            self._tiles.setdefault(zoom, set()).add((x, y))
            key = f"{x}|{y}|{focal}|{zoom}"
            self._colors[key] = max(self._colors.get(key, 0), color + 1)
        if not self._tiles:
            raise ValueError(f"{path}: no tiles in Sakura blob table")

        self.zooms = sorted(self._tiles)
        if self.width <= 0 or self.height <= 0:
            # defensive fallback: extent of the level-0 tile grid
            z0 = self.zooms[0]
            self.width = max(x for x, _ in self._tiles[z0]) + self.tile_w * z0
            self.height = max(y for _, y in self._tiles[z0]) + self.tile_h * z0
        self.pages = [
            SakuraPage(max(1, -(-self.width // z)), max(1, -(-self.height // z)),
                       self.tile_w, self.tile_h)
            for z in self.zooms
        ]
        self.properties = {}
        if meta["mpp"]:
            self.properties["mpp"] = meta["mpp"]
        self._assoc = self._associated_oids()
        # expose label/macro as pseudo-pages after the pyramid so the Slide
        # wrapper can surface them via associated_images (io/hamamatsu.py
        # uses the same page-extension pattern).  Only the JPEG HEADER is
        # parsed here (PIL reads dimensions lazily); the pixels are decoded
        # on first access — a corrupt associated blob must not make an
        # intact pyramid unopenable, and open stays cheap.
        self.n_levels = len(self.pages)
        self._assoc_cache: Dict[str, np.ndarray] = {}
        self.assoc_names = []
        for name in list(self._assoc):
            size = self._assoc_size(name)
            if size is not None:
                self.assoc_names.append(name)
                self.pages.append(SakuraPage(size[0], size[1], 0, 0))
        self.bounds = None

    # -- schema helpers -----------------------------------------------------

    def _tile_table(self) -> str:
        try:
            row = self._db.execute(
                "SELECT TableName FROM DataManagerSQLiteConfigXPO LIMIT 1"
            ).fetchone()
            if row and row[0]:
                return str(row[0])
        except sqlite3.Error:
            pass
        # fallback: the only table with (id, data) columns
        try:
            for (name,) in self._db.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"):
                cols = {r[1] for r in self._db.execute(
                    f'PRAGMA table_info("{name}")')}
                if {"id", "data"} <= cols:
                    return name
        except sqlite3.Error as e:
            # reader contract: corrupt databases surface as ValueError,
            # never sqlite3.Error (tests/test_corrupt_inputs.py)
            raise ValueError(
                f"{self.path}: corrupt Sakura database: {e}") from e
        raise ValueError(f"{self.path}: no Sakura tile table")

    def _scan_metadata(self) -> dict:
        out = dict(width=0, height=0, tile_w=256, tile_h=256, mpp=None)
        try:
            row = self._db.execute(
                "SELECT m_nImageWidth, m_nImageHeight, m_nTileWidth,"
                " m_nTileHeight, m_ResolutionMmPerPix"
                " FROM SVHRScanDataXPO LIMIT 1").fetchone()
        except sqlite3.Error:
            row = None
        if row:
            out["width"], out["height"] = int(row[0] or 0), int(row[1] or 0)
            out["tile_w"] = int(row[2] or 256)
            out["tile_h"] = int(row[3] or 256)
            if row[4]:
                out["mpp"] = float(row[4]) * 1000.0  # mm/px -> um/px
        return out

    def _associated_oids(self) -> Dict[str, int]:
        try:
            row = self._db.execute(
                "SELECT m_labelScan, m_overviewScan FROM SVSlideDataXPO"
                " LIMIT 1").fetchone()
        except sqlite3.Error:
            return {}
        if not row:
            return {}
        out = {}
        for name, oid in (("label", row[0]), ("macro", row[1])):
            if oid is not None:
                out[name] = int(oid)
        return out

    def _assoc_blob(self, name: str) -> Optional[bytes]:
        oid = self._assoc.get(name)
        if oid is None:
            return None
        try:
            with self._db_lock:
                row = self._db.execute(
                    "SELECT m_image FROM SVScannedImageDataXPO WHERE OID = ?",
                    (oid,)).fetchone()
        except sqlite3.Error:
            return None
        return row[0] if row else None

    def _assoc_size(self, name: str) -> Optional[Tuple[int, int]]:
        """(width, height) from the JPEG header only — no pixel decode."""
        blob = self._assoc_blob(name)
        if blob is None:
            return None
        from PIL import Image

        try:
            return Image.open(BytesIO(blob)).size
        except Exception:
            return None  # corrupt associated image: skip, keep the pyramid

    def read_associated(self, name: str) -> Optional[np.ndarray]:
        """Decode the label/macro JPEG from SVScannedImageDataXPO, if any.
        Decoded lazily (``Slide.associated_images`` contract) and cached."""
        arr = self._assoc_cache.get(name)
        if arr is not None:
            return arr
        blob = self._assoc_blob(name)
        if blob is None:
            return None
        from PIL import Image

        img = Image.open(BytesIO(blob))
        arr = np.asarray(img.convert("RGB"), np.uint8)
        self._assoc_cache[name] = arr
        return arr

    # -- pixels ---------------------------------------------------------------

    def _fetch(self, tid: str) -> Optional[bytes]:
        with self._db_lock:
            row = self._db.execute(
                f'SELECT data FROM "{self._table}" WHERE id = ?', (tid,)
            ).fetchone()
        return row[0] if row else None

    def _decode_tile(self, x0: int, y0: int, zoom: int) -> Optional[np.ndarray]:
        """(th, tw, 3) uint8 for the tile whose level-0 origin is (x0, y0)."""
        from PIL import Image

        ncolors = self._colors.get(f"{x0}|{y0}|0|{zoom}", 1)
        first = self._fetch(f"{x0}|{y0}|0|0|{zoom}")
        if first is None:
            return None
        img = Image.open(BytesIO(first))
        if ncolors < 3 or img.mode in ("RGB", "RGBA", "YCbCr"):
            return np.asarray(img.convert("RGB"), np.uint8)
        chans = [np.asarray(img.convert("L"), np.uint8)]
        for c in (1, 2):
            blob = self._fetch(f"{x0}|{y0}|0|{c}|{zoom}")
            if blob is None:  # incomplete channel set: replicate gray
                return np.repeat(chans[0][:, :, None], 3, axis=2)
            chans.append(np.asarray(
                Image.open(BytesIO(blob)).convert("L"), np.uint8))
        return np.stack(chans, axis=2)

    def read_region(self, level: int, x: int, y: int, w: int,
                    h: int) -> np.ndarray:
        """(h, w, 3) uint8 at ``level``; x/y are level-``level`` pixels."""
        if level >= self.n_levels:  # label/macro pseudo-page
            arr = self.read_associated(
                self.assoc_names[level - self.n_levels])
            return arr[y:y + h, x:x + w]
        zoom = self.zooms[level]
        out = np.full((h, w, 3), 255, np.uint8)  # absent tiles are white
        tw, th = self.tile_w, self.tile_h
        tx0, ty0 = x // tw, y // th
        tx1, ty1 = (x + w - 1) // tw, (y + h - 1) // th
        occupied = self._tiles[zoom]
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                # ids key tiles by their LEVEL-0 pixel origin
                x0, y0 = tx * tw * zoom, ty * th * zoom
                if (x0, y0) not in occupied:
                    continue
                arr = self._decode_tile(x0, y0, zoom)
                if arr is None:
                    continue
                px, py = tx * tw, ty * th
                sx0, sy0 = max(x - px, 0), max(y - py, 0)
                sx1 = min(x + w - px, arr.shape[1])
                sy1 = min(y + h - py, arr.shape[0])
                if sx0 >= sx1 or sy0 >= sy1:
                    continue
                out[py + sy0 - y:py + sy1 - y,
                    px + sx0 - x:px + sx1 - x] = arr[sy0:sy1, sx0:sx1]
        return out

    def close(self):
        self._db.close()


def detect_sakura(path: str) -> Optional[str]:
    """'sakura' if ``path`` is an SQLite file carrying a Sakura schema."""
    p = str(path)
    if not os.path.isfile(p) or os.path.getsize(p) < 100:
        return None
    try:
        with open(p, "rb") as f:
            if f.read(16) != _SQLITE_MAGIC:
                return None
        db = sqlite3.connect(f"file:{p}?mode=ro", uri=True)
        try:
            names = {r[0] for r in db.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")}
        finally:
            db.close()
    except (OSError, sqlite3.Error):
        return None
    if "SVSlideDataXPO" in names or "DataManagerSQLiteConfigXPO" in names:
        return "sakura"
    return None
