"""The synthetic slide fixtures of ``tests/fixtures.py``, written by the
PyTorch port's own TIFF writer.

The fixture makers import the JAX package's pure-numpy writer modules
(``digipathai_tpu.io.tiff_py``, ``digipathai_tpu.io.backend``).  The port
holds byte copies of both under ``digipathai_tpu_torch.io``, so the tools
of the port load ``tests/fixtures.py`` by its path (another installed
package may own the top-level name ``tests``) with those imports pointed
at the copies: the same files, and no module of the JAX package loaded.
"""

from __future__ import annotations

import importlib.util
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures.py")

_JAX_IO = re.compile(r"\bdigipathai_tpu\.io\b")
_JAX_ANY = re.compile(r"^\s*(from|import)\s+digipathai_tpu\b(?!_)", re.M)

_loaded = None


def load():
    """``tests/fixtures.py`` as a module whose makers write through
    ``digipathai_tpu_torch.io``."""
    global _loaded
    if _loaded is None:
        with open(FIXTURES) as f:
            src = _JAX_IO.sub("digipathai_tpu_torch.io", f.read())
        if _JAX_ANY.search(src):
            raise ImportError(f"{FIXTURES} imports more of digipathai_tpu "
                              "than its io modules")
        spec = importlib.util.spec_from_loader("dpai_torch_fixtures",
                                               loader=None)
        mod = importlib.util.module_from_spec(spec)
        mod.__file__ = FIXTURES
        exec(compile(src, FIXTURES, "exec"), mod.__dict__)
        _loaded = mod
    return _loaded


def make_synthetic_slide(path, width=2048, height=1536, seed=0, **kw):
    """``tests/fixtures.py::make_synthetic_slide`` through the port's
    writer."""
    return load().make_synthetic_slide(path, width, height, seed, **kw)
