"""Backend selection for TIFF I/O: native C++ (libtiff) or pure Python.

The native backend lives in ``digipathai_tpu_torch/native`` (C++, built with
``make -C digipathai_tpu_torch/native``). Set ``DPAI_NATIVE=0`` to force the pure
Python path; ``DPAI_NATIVE=1`` to require the native path (raises if the
shared library is missing).
"""

from __future__ import annotations

import os

from . import tiff_py

_FORCED = os.environ.get("DPAI_NATIVE", "").strip()


def _native_available() -> bool:
    try:
        from . import native  # noqa: F401

        return native.available()
    except Exception:
        return False


def use_native() -> bool:
    if _FORCED == "0":
        return False
    if _FORCED == "1":
        if not _native_available():
            raise RuntimeError(
                "DPAI_NATIVE=1 but the native library is not built; "
                "run `make -C digipathai_tpu_torch/native`"
            )
        return True
    return _native_available()


def open_tiff(path: str):
    """Open a TIFF for reading with the best available backend."""
    if use_native():
        from . import native

        return native.NativeTiffReader(path)
    return tiff_py.TiffReader(path)


def write_pyramid(path, array, **kw):
    """Write a tiled pyramidal TIFF with the best available backend."""
    if use_native():
        from . import native

        try:
            return native.write_pyramidal_tiff(path, array, **kw)
        except NotImplementedError:
            pass
    return tiff_py.write_pyramidal_tiff(path, array, **kw)
