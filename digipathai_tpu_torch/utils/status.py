"""Thread-safe segmentation status channel.

The reference shares a bare dict between the Flask request threads and the
segmentation thread with no synchronization
(``reference DigiPathAI/main_server.py:107,148-177``) — safe only by GIL
accident.  This object keeps the exact wire format (``status`` string +
``progress`` int, polled as JSON) but locks mutations, and adds an ``error``
field so a crashed run doesn't leave the UI stuck at "Running" (the
reference's failure mode, SURVEY.md §5).
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class SegmentationStatus:
    def __init__(self, initial: Dict[str, Any] | None = None):
        self._lock = threading.Lock()
        self._d: Dict[str, Any] = {"status": ""}
        if initial:
            self._d.update(initial)

    def __setitem__(self, key: str, value: Any):
        with self._lock:
            self._d[key] = value

    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._d[key]

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._d

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._d.get(key, default)

    def update(self, **kw):
        with self._lock:
            self._d.update(kw)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._d)
