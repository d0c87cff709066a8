"""The viewer and segmentation server on the port's engine.

A copy of ``digipathai_tpu/server``: the same routes, pages and config, and
``POST /segment`` runs the port's ``getSegmentation``.
``ServerConfig.engine_extra`` reaches it verbatim, e.g. ``{"device": "cuda:1"}``.
The ``digipathai-torch`` console script (``server/cli.py``) and
``wsgi_torch.py`` (uwsgi: ``deploy/digipathai_torch.ini``) serve it.
"""

from .app import ServerConfig, create_app
from .wsgi_kit import serve

__all__ = ["ServerConfig", "create_app", "serve"]
