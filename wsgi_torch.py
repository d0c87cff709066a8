"""WSGI entry point of the PyTorch port for production servers
(uwsgi/gunicorn).

The counterpart of ``wsgi.py`` on ``digipathai_tpu_torch.server.app``.
Configure via environment:

    DPAI_SLIDE_DIR     slide directory (default '.')
    DPAI_VIEWER_ONLY   '1' (default) to disable segmentation

Segmentation runs on the port's engine, on the card by default (the
engine's ``device="cuda"``).  Loading this module imports no ``torch``:
uwsgi loads it in its master and then forks the workers, and a master
that had touched CUDA would hand every worker a broken context.  The
engine (and ``torch``) load in the worker that takes the first
``POST /segment``.

Example: ``uwsgi --ini deploy/digipathai_torch.ini``
"""

import os

from digipathai_tpu_torch.server.app import ServerConfig, create_app

application = create_app(ServerConfig(
    slide_dir=os.environ.get("DPAI_SLIDE_DIR", "."),
    viewer_only=os.environ.get("DPAI_VIEWER_ONLY", "1") != "0",
))
