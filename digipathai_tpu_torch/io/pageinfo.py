"""Shared TiffPage-compatible level descriptor for non-TIFF slide formats.

The directory/DB formats (MRXS — io/mirax.py, VMS/VMU — io/hamamatsu.py,
Sakura SVSLIDE — io/sakura.py) synthesize pyramid levels that aren't backed
by TIFF IFDs; the ``Slide`` wrapper (io/slide.py) only reads the attribute
set below from a page.  One shared descriptor keeps the three readers from
drifting when Slide grows a new page-facing attribute.
"""

from __future__ import annotations


class SyntheticPage:
    """Level / associated-image descriptor with the TiffPage attributes the
    ``Slide`` wrapper consumes (width/height/tile_*/description/compression/
    tag_ids/x_resolution/resolution_unit)."""

    def __init__(self, width, height, tile_width=0, tile_height=0):
        self.width = int(width)
        self.height = int(height)
        self.tile_width = int(tile_width)
        self.tile_height = int(tile_height)
        self.description = ""
        self.compression = 7  # JPEG payloads for all current users
        self.tag_ids = ()
        self.x_resolution = 0.0
        self.resolution_unit = 2
