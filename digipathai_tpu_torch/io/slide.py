"""Whole-slide-image abstraction with OpenSlide-compatible semantics.

First-party replacement for ``openslide.OpenSlide`` as used by the reference
(``reference DigiPathAI/loaders/dataloader.py:239-247,357`` and
``reference DigiPathAI/main_server.py:54-55``):

- ``level_dimensions`` / ``level_downsamples`` / ``level_count``
- ``read_region((x, y), level, (w, h))`` with *level-0* coordinates and a
  ``(w, h)`` size, returning an (h, w, c) uint8 RGB array
- ``detect_format(path)`` for directory scans
- ``properties`` with an ``mpp`` entry parsed from the image description
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from .backend import open_tiff


_J2K_COMPRESSIONS = (33003, 33005)  # Aperio SVS JPEG2000 flavors


class Slide:
    def __init__(self, path: str):
        self.path = str(path)
        from .mirax import detect_mirax

        from .hamamatsu import detect_vms

        from .sakura import detect_sakura

        if detect_mirax(self.path):
            # 3DHISTECH Mirax: directory format (io/mirax.py)
            from .mirax import MiraxReader

            self._r = MiraxReader(self.path)
            self._pages = self._r.pages
            self._page_index = list(range(len(self._pages)))
            self._associated = {}
        elif detect_sakura(self.path):
            # Sakura SVSLIDE: SQLite database of JPEG tile blobs
            # (io/sakura.py); label/macro ride as pseudo-pages
            from .sakura import SakuraReader

            self._r = SakuraReader(self.path)
            self._pages = self._r.pages[:self._r.n_levels]
            self._page_index = list(range(self._r.n_levels))
            self._associated = {name: self._r.n_levels + i for i, name in
                                enumerate(self._r.assoc_names)}
        elif detect_vms(self.path):
            # Hamamatsu VMS/VMU: INI index + JPEG/NGR payload files
            # (io/hamamatsu.py); one level + map/macro associated images
            from .hamamatsu import VmsReader

            self._r = VmsReader(self.path)
            self._pages = [self._r.pages[0]]
            self._page_index = [0]
            self._associated = {name: i + 1 for i, name in
                                enumerate(self._r._assoc_files)}
        elif self._sniff_ndpi(self.path):
            # Hamamatsu NDPI: single-JPEG strips with restart-marker
            # random access need the dedicated reader (io/ndpi.py); the
            # native libtiff backend can't open these at all.
            from .ndpi import NdpiReader

            self._r = NdpiReader(self.path)
            self._select_ndpi_pages()
        elif (vendor := self._sniff_vendor(self.path)):
            # Leica SCN / Philips TIFF / Ventana BIF: TIFF containers whose
            # pyramid layout and pixel pitch live in vendor XML
            # (io/vendor_tiff.py); the Python reader surfaces the needed
            # tags (700/XMP, per-page descriptions, sparse tiles).
            from . import tiff_py

            self._r = tiff_py.TiffReader(self.path)
            self._apply_vendor(vendor)
        else:
            self._r = open_tiff(self.path)
            if not self._r.pages:
                raise ValueError(f"{path}: no images in file")
            self._select_pages()
            # JPEG2000 SVS tiles need the Python reader (PIL/OpenJPEG);
            # libtiff builds commonly lack the Aperio 33003/33005 codecs.
            if any(getattr(p, "compression", 0) in _J2K_COMPRESSIONS
                   for p in self._pages):
                from . import tiff_py

                if not isinstance(self._r, tiff_py.TiffReader):
                    self._r.close()
                    self._r = tiff_py.TiffReader(self.path)
                    self._select_pages()
        self.properties = self._parse_properties()

    @staticmethod
    def _sniff_ndpi(path: str) -> bool:
        """Header-only NDPI check with the Python parser (the native
        backend neither surfaces private tags nor reads NDPI strips)."""
        from . import tiff_py

        try:
            with tiff_py.TiffReader(path) as r:
                return bool(r.pages) and 65420 in r.pages[0].tag_ids
        except (OSError, ValueError, struct.error):
            return False

    @staticmethod
    def _sniff_vendor(path: str) -> Optional[str]:
        from .vendor_tiff import sniff_vendor_file

        return sniff_vendor_file(path)

    def _apply_vendor(self, vendor: str):
        from . import vendor_tiff

        self._vendor = vendor
        if vendor == "leica":
            level_ifds, associated, props = vendor_tiff.leica_layout(
                self._r.pages)
            self._page_index = level_ifds
            self._pages = [self._r.pages[i] for i in level_ifds]
            self._associated = associated
            self._vendor_props = props
            return
        if vendor == "trestle":
            # wrap reads with per-level tile-overlap subtraction BEFORE
            # page selection so level dimensions are the logical ones
            self._r = vendor_tiff.TrestleReader(self._r)
            self._select_pages()
            self._vendor_props = vendor_tiff.trestle_props(self._r.pages)
            return
        self._select_pages()
        if vendor == "philips":
            for p in self._r.pages:
                p.sparse_fill = 255  # absent tiles are defined white
            self._vendor_props = vendor_tiff.philips_props(self._r.pages)
        else:  # ventana
            self._vendor_props = vendor_tiff.ventana_props(self._r.pages)

    def _select_ndpi_pages(self):
        """NDPI pyramid = IFDs with SourceLens > 0, area-descending; the
        macro (-1) and map (-2) images become ``associated_images``."""
        from .ndpi import NdpiReader

        pages = list(self._r.pages)
        levels, self._associated = [], {}
        for i, p in enumerate(pages):
            lens = NdpiReader.source_lens(p)
            if lens is not None and lens > 0:
                levels.append((i, p))
            elif lens is not None:
                self._associated["macro" if lens == -1 else "map"] = i
        if not levels:  # defensive: treat all pages as levels
            levels = list(enumerate(pages))
        levels.sort(key=lambda ip: (-ip[1].width * ip[1].height, ip[0]))
        self._page_index = [i for i, _ in levels]
        self._pages = [p for _, p in levels]

    def _select_pages(self):
        """Pick the pyramid levels out of the file's IFD sequence.

        Scanner TIFFs (Aperio SVS) interleave non-pyramid images with the
        levels: IFD 0 is the tiled full-res image, IFD 1 a *stripped*
        thumbnail, then tiled downsamples, then stripped label/macro images
        (reference reads these via OpenSlide, ``main_server.py:54-55``).
        Rule: when any page is tiled, the pyramid = tiled pages sorted by
        area descending and the stripped pages become ``associated_images``;
        otherwise (plain flat TIFFs) keep the leading non-growing run.
        """
        pages = list(self._r.pages)
        tiled = [(i, p) for i, p in enumerate(pages) if p.tile_width > 0]
        self._associated: dict = {}
        if tiled:
            tiled.sort(key=lambda ip: (-ip[1].width * ip[1].height, ip[0]))
            self._page_index = [i for i, _ in tiled]
            self._pages = [p for _, p in tiled]
            for i, p in enumerate(pages):
                if p.tile_width > 0:
                    continue
                desc = (getattr(p, "description", "") or "").lower()
                name = ("label" if "label" in desc else
                        "macro" if "macro" in desc else "thumbnail")
                if name in self._associated:  # e.g. native path: no per-page
                    name = f"{name}-{i}"      # descriptions to tell them apart
                self._associated[name] = i
        else:
            keep = []
            for i, p in enumerate(pages):
                if keep and (p.width > keep[-1][1].width
                             or p.height > keep[-1][1].height):
                    break
                keep.append((i, p))
            self._page_index = [i for i, _ in keep]
            self._pages = [p for _, p in keep]

    # -- metadata ---------------------------------------------------------

    @property
    def level_count(self) -> int:
        return len(self._pages)

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        """((w0, h0), (w1, h1), ...) like OpenSlide (width first)."""
        return tuple((p.width, p.height) for p in self._pages)

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    @property
    def level_downsamples(self) -> Tuple[float, ...]:
        w0, h0 = self.dimensions
        return tuple(((w0 / p.width) + (h0 / p.height)) / 2 for p in self._pages)

    @property
    def mpp(self) -> Optional[float]:
        v = self.properties.get("mpp")
        return float(v) if v is not None else None

    @property
    def bounds(self) -> Optional[Tuple[int, int, int, int]]:
        """(x, y, w, h) non-empty bounds in level-0 px, or None.

        TIFF/SVS record no bounds metadata; MRXS populates it from the
        occupied camera grid (io/mirax.py) — DeepZoomGenerator honors it
        for ``limit_bounds`` (OpenSlide parity)."""
        return getattr(self._r, "bounds", None)

    @property
    def associated_images(self) -> dict:
        """name -> (h, w, 3) uint8 array of non-pyramid images (SVS
        thumbnail / label / macro), decoded lazily."""
        return {name: self._read_page_whole(i)
                for name, i in self._associated.items()}

    def _parse_properties(self) -> dict:
        props = dict(getattr(self._r, "properties", {}) or {})
        desc = self._pages[0].description or ""
        if desc.lstrip().startswith("<"):
            # XML description (Leica SCN, Philips, Ventana): already parsed
            # by the vendor reader into _vendor_props — the Aperio-style
            # key=value scrape below would shred the XML into garbage keys
            desc = ""
        for part in desc.replace("\n", "|").split("|"):
            if "=" in part:
                k, _, v = part.partition("=")
                props[k.strip()] = v.strip()
        props.update(getattr(self, "_vendor_props", {}) or {})
        if "mpp" not in props:
            # Aperio-style "MPP = 0.25" inside the description
            low = desc.lower()
            if "mpp" in low:
                for tok in low.replace(";", "|").split("|"):
                    if "mpp" in tok and "=" in tok:
                        try:
                            props["mpp"] = float(tok.split("=")[-1].strip())
                        except ValueError:
                            pass
        if "mpp" not in props:
            # resolution-tag fallback (OpenSlide derives mpp the same way)
            page = self._pages[0]
            xres = getattr(page, "x_resolution", 0.0)
            if xres:
                per_cm = xres if getattr(page, "resolution_unit", 2) == 3 \
                    else xres / 2.54
                if per_cm > 0:
                    props["mpp"] = 10000.0 / per_cm
        if getattr(self._pages[0], "ndpi", None):
            from .ndpi import NdpiReader

            lens = NdpiReader.source_lens(self._pages[0])
            if lens and lens > 0:
                props["openslide.objective-power"] = lens
        return props

    # -- pixels -----------------------------------------------------------

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """Read (w, h) pixels at ``level``; ``location`` is in level-0 coords.

        Returns an (h, w, 3) uint8 RGB array (grayscale is broadcast to RGB
        to mirror the reference's ``.convert('RGB')`` calls).
        """
        x0, y0 = location
        w, h = size
        ds = self.level_downsamples[level]
        x = int(round(x0 / ds))
        y = int(round(y0 / ds))
        arr = self._r.read_region(self._page_index[level], x, y, int(w), int(h))
        return self._to_rgb8(arr)

    @staticmethod
    def _to_rgb8(arr: np.ndarray) -> np.ndarray:
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8) if arr.dtype.kind == "f" else arr.astype(np.uint8)
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        elif arr.shape[2] > 3:
            arr = arr[:, :, :3]
        return arr

    def _read_page_whole(self, page_idx: int) -> np.ndarray:
        p = self._r.pages[page_idx]
        return self._to_rgb8(
            self._r.read_region(page_idx, 0, 0, p.width, p.height))

    def read_level(self, level: int) -> np.ndarray:
        w, h = self.level_dimensions[level]
        return self.read_region((0, 0), level, (w, h))

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 0.01:
                best = i
        return best

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- format sniffing --------------------------------------------------

    @staticmethod
    def detect_format(path: str) -> Optional[str]:
        """Return a format name if ``path`` is a readable slide, else None.

        Mirrors ``OpenSlide.detect_format`` for the formats this stack can
        actually open: ``"aperio"`` (SVS, incl. JPEG2000-compressed),
        ``"hamamatsu"`` (NDPI via restart-marker surgery ``io/ndpi.py``;
        VMS/VMU ``io/hamamatsu.py``), ``"mirax"`` (directory-based MRXS,
        ``io/mirax.py``), ``"sakura"`` (SVSLIDE SQLite, ``io/sakura.py``),
        ``"leica"`` / ``"philips"`` / ``"ventana"`` / ``"trestle"``
        (vendor TIFF containers, ``io/vendor_tiff.py``) and
        ``"generic-tiff"``.
        """
        try:
            from .hamamatsu import detect_vms
            from .mirax import detect_mirax
            from .sakura import detect_sakura

            m = detect_mirax(path) or detect_vms(path) or detect_sakura(path)
            if m:
                return m
            if os.path.getsize(path) < 8:
                return None
            with open(path, "rb") as f:
                head = f.read(4)
            if not (head[:2] in (b"II", b"MM") and head[2:4] in (
                b"\x2a\x00", b"\x00\x2a", b"\x2b\x00", b"\x00\x2b"
            )):
                return None
            from . import tiff_py

            with tiff_py.TiffReader(path) as r:
                if not r.pages:
                    return None
                p0 = r.pages[0]
                if 65420 in p0.tag_ids:
                    return "hamamatsu"  # NDPI (io/ndpi.py)
                if (p0.description or "").startswith("Aperio"):
                    return "aperio"
                from .vendor_tiff import sniff_vendor

                vendor = sniff_vendor(p0)
                if vendor:
                    return vendor  # leica / philips / ventana
                return "generic-tiff"
        except (OSError, ValueError, struct.error):
            return None


def read_whole_slide_image(image_path):
    """Load an ordinary (non-pyramidal) image file whole, as a PIL image.

    Parity target: ``ReadWholeSlideImage`` (``reference DigiPathAI/helpers/
    utils.py:308-310``) — a thin ``PIL.Image.open`` used by the legacy
    in-RAM dataset (``loaders/dataloader.py:34-188``).  Slide formats PIL
    cannot parse fall back to the coarsest level of the first-party
    ``Slide`` reader (returned as a PIL image for interface parity).
    """
    from PIL import Image

    try:
        return Image.open(image_path)
    except Exception:
        with Slide(image_path) as s:  # read_region copies; don't leak the fd
            lvl = s.level_count - 1
            return Image.fromarray(np.asarray(
                s.read_region((0, 0), lvl, s.level_dimensions[lvl])))
