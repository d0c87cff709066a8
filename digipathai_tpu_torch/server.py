"""The viewer and segmentation server on the port's engine.

The WSGI app, its routes and its config are the JAX package's
(``digipathai_tpu/server/app.py`` loads no jax); only the segmentation
function differs.  ``ServerConfig.engine_extra`` reaches ``getSegmentation``
verbatim, e.g. ``{"device": "cuda:1"}``.
"""

from __future__ import annotations

from digipathai_tpu.server.app import ServerConfig
from digipathai_tpu.server.app import create_app as _create_app
from digipathai_tpu.server.wsgi_kit import serve

__all__ = ["ServerConfig", "create_app", "serve"]


def create_app(config=None, segmentation_fn=None):
    """The WSGI app; ``POST /segment`` runs the port's ``getSegmentation``."""
    if segmentation_fn is None:
        from .engine.segmentation import getSegmentation as segmentation_fn
    return _create_app(config, segmentation_fn=segmentation_fn)
