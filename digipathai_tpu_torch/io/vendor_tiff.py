"""Vendor-flavored TIFF slide formats: Leica SCN, Philips TIFF, Ventana BIF,
Trestle TIFF.

The reference opens these through OpenSlide's format drivers (any slide
``OpenSlide.detect_format`` accepts — ``reference
DigiPathAI/main_server.py:54-55``).  All three are (Big)TIFF containers that
differ from generic pyramidal TIFF only in *metadata interpretation*:

- **Leica SCN** (``.scn``): BigTIFF whose IFD-0 ImageDescription is an XML
  document (namespace ``…leica-microsystems.com/scn/…``) describing a
  ``collection`` of ``image`` elements.  Each image's ``pixels`` element
  lists its pyramid as ``dimension`` children carrying explicit ``ifd``
  indices; a macro image covers the whole collection while the main image
  covers a sub-rectangle (its ``view`` offset/size, in nm).  The IFD order
  in the file is NOT area-sorted and the macro is tiled too, so the generic
  "tiled pages by area" rule would interleave the two images — level
  selection must follow the XML.
- **Philips TIFF** (``.tiff``): IFD-0 ImageDescription is a Philips
  ``DataObject`` XML (``ObjectType="DPUfsImport"``).  Pyramid levels are
  tiled IFDs; ``Macro`` / ``Label`` images are non-tiled IFDs whose
  description is exactly that word.  Quirk: background tiles are OMITTED
  (tile offset/bytecount 0) and defined to be white — handled by
  ``TiffPage.sparse_fill`` (tiff_py.py).  Pixel pitch comes from the
  ``DICOM_PIXEL_SPACING`` attribute (mm).
- **Ventana BIF** (``.bif``): BigTIFF whose IFD-0 carries an XMP packet
  (tag 700) with an ``iScan`` element (``ScanRes`` = µm/px,
  ``Magnification``).  Tiled IFDs form the pyramid; ``Label Image`` /
  ``Thumbnail`` IFDs are associated images.  (Ventana's level-0 AOI
  overlap correction is out of scope — levels are read as stored, which is
  what several open readers do; documented in PARITY.md.)

- **Trestle TIFF** (``.tif``): tiled pyramid whose IFD-0 ImageDescription
  is a ``;``-separated key=value list including ``OverlapsXY=ox0 oy0 ox1
  oy1 …`` — per-level pixel overlaps between adjacent tiles.  Logical level
  size is the stored size minus ``overlap x (tiles-1)`` per axis; a logical
  pixel in an overlap band shows the LATER tile's pixels (tiles painted in
  ascending order, as OpenSlide's trestle driver does).

Caveat (as for MRXS, io/mirax.py): no real scanner output exists in this
offline environment, so the layouts are validated against self-authored
fixtures (``tests/fixtures.py``) that follow the documented structures.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree


def sniff_vendor(page0) -> Optional[str]:
    """Classify a parsed TIFF's vendor flavor from IFD-0 metadata alone.

    Returns ``"leica"``, ``"philips"``, ``"ventana"`` or None (mirrors the
    names ``OpenSlide.detect_format`` uses for these drivers).
    """
    desc = page0.description or ""
    if "<scn" in desc and "leica-microsystems.com/scn" in desc:
        return "leica"
    if "DPUfsImport" in desc and "<DataObject" in desc:
        return "philips"
    xmp = page0.xmp or b""
    if b"iScan" in xmp or "iScan" in desc:
        return "ventana"
    if "OverlapsXY=" in desc:
        return "trestle"
    return None


# -- Leica SCN --------------------------------------------------------------


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def leica_layout(pages) -> Tuple[List[int], Dict[str, int], dict]:
    """Parse the SCN collection XML into (level_ifds, associated, props).

    The main image is the one whose ``view`` does NOT cover the whole
    collection (macro images span it); with a single image, that image is
    the main one.  Levels are its ``dimension`` elements ordered by ``r``
    (zoom index), restricted to the base z-plane when a ``z`` attribute is
    present (fluorescence stacks are out of scope, as in the reference's
    brightfield pipeline).
    """
    try:
        return _leica_layout(pages)
    except (ValueError, OSError):
        raise
    except Exception as e:
        # boundary for untrusted metadata: sniff_vendor classifies "leica"
        # by substring only, so the XML here can be arbitrarily malformed —
        # ElementTree.ParseError (a SyntaxError subclass), StopIteration
        # from a missing element, TypeError from a missing attribute must
        # all surface as the documented reader contract
        # (tests/test_corrupt_inputs.py)
        raise ValueError(f"corrupt Leica SCN metadata: {e!r}") from e


def _leica_layout(pages) -> Tuple[List[int], Dict[str, int], dict]:
    root = ElementTree.fromstring(pages[0].description)
    coll = next(e for e in root if _local(e.tag) == "collection")
    csx = int(coll.get("sizeX", 0) or 0)
    csy = int(coll.get("sizeY", 0) or 0)
    images = []
    for img in (e for e in coll if _local(e.tag) == "image"):
        view = next((e for e in img if _local(e.tag) == "view"), None)
        pixels = next(e for e in img if _local(e.tag) == "pixels")
        dims = []
        for d in (e for e in pixels if _local(e.tag) == "dimension"):
            if int(d.get("z", 0) or 0) or int(d.get("c", 0) or 0):
                continue
            dims.append((int(d.get("r", 0) or 0), int(d.get("ifd")),
                         int(d.get("sizeX")), int(d.get("sizeY"))))
        dims.sort()
        vsx = int(view.get("sizeX", csx) or csx) if view is not None else csx
        vsy = int(view.get("sizeY", csy) or csy) if view is not None else csy
        off = (int(view.get("offsetX", 0) or 0),
               int(view.get("offsetY", 0) or 0)) if view is not None else (0, 0)
        covers_all = off == (0, 0) and vsx >= csx and vsy >= csy
        images.append(dict(dims=dims, view=(vsx, vsy), offset=off,
                           macro=covers_all,
                           px=dims[0][2] * dims[0][3] if dims else 0))
    if not images:
        raise ValueError("SCN XML contains no image elements")
    mains = [im for im in images if not im["macro"]] or images
    main = max(mains, key=lambda im: im["px"])

    level_ifds = [ifd for _, ifd, _, _ in main["dims"]]
    associated: Dict[str, int] = {}
    for im in images:
        if im is main or not im["dims"]:
            continue
        name = "macro" if im["macro"] else "related"
        if name in associated:
            name = f"{name}-{im['dims'][0][1]}"
        associated[name] = im["dims"][0][1]

    props: dict = {}
    _, _, psx, psy = main["dims"][0]
    if psx and main["view"][0]:
        props["mpp"] = main["view"][0] / psx / 1000.0  # nm/px -> µm/px
    obj = root.iter()
    for e in obj:
        if _local(e.tag) == "objective" and (e.text or "").strip():
            try:
                props["openslide.objective-power"] = float(e.text.strip())
            except ValueError:
                pass
            break
    return level_ifds, associated, props


# -- Philips TIFF -------------------------------------------------------------


def philips_props(pages) -> dict:
    """Pull mpp out of the Philips DataObject XML (DICOM_PIXEL_SPACING is
    row/column spacing in mm)."""
    desc = pages[0].description or ""
    props: dict = {}
    m = re.search(
        r'Name="DICOM_PIXEL_SPACING"[^>]*>\s*"?([0-9.eE+-]+)"?', desc)
    if m:
        try:
            props["mpp"] = float(m.group(1)) * 1000.0  # mm -> µm
        except ValueError:
            pass
    return props


# -- Ventana BIF --------------------------------------------------------------


def ventana_props(pages) -> dict:
    blob = (pages[0].xmp or b"").decode("utf-8", "replace") or \
        (pages[0].description or "")
    props: dict = {}
    m = re.search(r'ScanRes="([0-9.eE+-]+)"', blob)
    if m:
        try:
            props["mpp"] = float(m.group(1))
        except ValueError:
            pass
    m = re.search(r'Magnification="([0-9.eE+-]+)"', blob)
    if m:
        try:
            props["openslide.objective-power"] = float(m.group(1))
        except ValueError:
            pass
    return props


# -- Trestle TIFF -------------------------------------------------------------


class _TrestlePage:
    """Page view with the tile overlaps subtracted from the logical size."""

    def __init__(self, page, ox: int, oy: int):
        self._page = page
        self.overlap = (ox, oy)
        tw, th = page.tile_width, page.tile_height
        ncols = -(-page.width // tw) if tw else 1
        nrows = -(-page.height // th) if th else 1
        self.width = page.width - ox * max(0, ncols - 1)
        self.height = page.height - oy * max(0, nrows - 1)
        for attr in ("tile_width", "tile_height", "description",
                     "compression", "tag_ids", "x_resolution",
                     "resolution_unit"):
            setattr(self, attr, getattr(page, attr, None))


class TrestleReader:
    """TiffReader wrapper applying Trestle per-level tile overlaps.

    Tile c's logical origin is ``c * (tile - overlap)``; tiles are painted
    ascending so overlap bands show the later tile (OpenSlide behavior).
    Non-tiled pages (label/macro) pass through unchanged.
    """

    def __init__(self, reader):
        self._r = reader
        desc = reader.pages[0].description or ""
        ov: List[int] = []
        for part in desc.split(";"):
            k, _, v = part.partition("=")
            if k.strip() == "OverlapsXY":
                ov = [int(t) for t in v.split()]
        self.properties = dict(getattr(reader, "properties", {}) or {})
        tiled = 0
        self.pages = []
        for p in reader.pages:
            if p.tile_width:
                ox = ov[2 * tiled] if 2 * tiled < len(ov) else 0
                oy = ov[2 * tiled + 1] if 2 * tiled + 1 < len(ov) else 0
                self.pages.append(_TrestlePage(p, ox, oy))
                tiled += 1
            else:
                self.pages.append(p)

    def read_region(self, idx: int, x: int, y: int, w: int,
                    h: int):
        import numpy as np

        page = self.pages[idx]
        if not isinstance(page, _TrestlePage):
            return self._r.read_region(idx, x, y, w, h)
        base = page._page
        ox, oy = page.overlap
        tw, th = base.tile_width, base.tile_height
        ax, ay = tw - ox, th - oy
        out = None
        tc0, tc1 = max(0, x) // ax, max(0, x + w - 1) // ax
        tr0, tr1 = max(0, y) // ay, max(0, y + h - 1) // ay
        ncols, nrows = -(-base.width // tw), -(-base.height // th)
        for tr in range(tr0, min(tr1, nrows - 1) + 1):
            for tc in range(tc0, min(tc1, ncols - 1) + 1):
                # logical tile span [tc*ax, tc*ax + tw) — intersect request
                lx0, ly0 = max(x, tc * ax), max(y, tr * ay)
                lx1 = min(x + w, tc * ax + tw, page.width)
                ly1 = min(y + h, tr * ay + th, page.height)
                if lx0 >= lx1 or ly0 >= ly1:
                    continue
                sub = self._r.read_region(
                    idx, tc * tw + (lx0 - tc * ax),
                    tr * th + (ly0 - tr * ay), lx1 - lx0, ly1 - ly0)
                if out is None:
                    out = np.zeros((h, w) + sub.shape[2:], sub.dtype)
                out[ly0 - y:ly1 - y, lx0 - x:lx1 - x] = sub
        if out is None:
            out = np.zeros((h, w, 3), "uint8")
        return out

    def close(self):
        self._r.close()


def trestle_props(pages) -> dict:
    """``;``-separated key=value pairs from IFD-0 (OpenSlide exposes them
    as ``trestle.*``); no mpp is recorded — resolution tags provide it."""
    desc = pages[0].description or ""
    props: dict = {}
    for part in desc.split(";"):
        k, _, v = part.partition("=")
        if "=" in part and k.strip():
            props[f"trestle.{k.strip()}"] = v.strip()
    return props


def sniff_vendor_file(path: str) -> Optional[str]:
    """Header-only vendor sniff with the Python parser (the native backend
    surfaces neither tag 700 nor full descriptions for every page)."""
    from . import tiff_py

    try:
        with tiff_py.TiffReader(path) as r:
            if not r.pages:
                return None
            return sniff_vendor(r.pages[0])
    except (OSError, ValueError, struct.error):
        return None
