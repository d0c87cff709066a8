"""Double-buffered threaded host loader feeding the engine.

Replaces the reference's fork-based ``torch.utils.data.DataLoader``
(``reference DigiPathAI/Segmentation.py:92``) with a thread pool over the
thread-safe pread-based TIFF reader: no process forks, no tensor copies, and
patches stay uint8 end-to-end (device normalizes), quartering host->device
transfer volume.  A bounded output queue provides backpressure so decode
overlaps device compute (classic double buffering).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .planner import PatchPlan


@dataclass
class Batch:
    group_index: int
    batch_index: int           # within the group
    batches_in_group: int
    patches: np.ndarray        # (B, P, P, 3) uint8, reference (x, y, c) layout
    offsets: np.ndarray        # (B, 2) int32 — offsets inside the supertile acc
    valid: np.ndarray          # (B,) bool


class PatchLoader:
    """Iterates device-ready batches for every supertile group in the plan."""

    def __init__(self, slide, plan: PatchPlan, num_workers: int = 8,
                 queue_depth: int = 4, skip_groups=None):
        self.slide = slide
        self.plan = plan
        self.num_workers = max(1, num_workers)
        self.queue_depth = queue_depth
        self.skip_groups = set(skip_groups or ())
        self._err: Optional[BaseException] = None

    def _read_patch(self, x: int, y: int) -> np.ndarray:
        p = self.plan.patch
        region = self.slide.read_region((int(x), int(y)), 0, (p, p))  # (p, p, 3)
        return np.transpose(region, (1, 0, 2))  # -> (x, y, c), reference layout

    def _assemble(self, pool: ThreadPoolExecutor, gi: int, bi: int) -> Batch:
        plan = self.plan
        g = plan.groups[gi]
        b = plan.batch
        coords = g.coords[bi * b:(bi + 1) * b]
        valid = g.valid[bi * b:(bi + 1) * b]
        patches = np.empty((b, plan.patch, plan.patch, 3), np.uint8)
        futures = [
            pool.submit(self._read_patch, x, y) if ok else None
            for (x, y), ok in zip(coords, valid)
        ]
        for i, fut in enumerate(futures):
            patches[i] = fut.result() if fut is not None else 0
        offsets = np.stack([
            coords[:, 0] - g.origin[0], coords[:, 1] - g.origin[1]
        ], axis=1).astype(np.int32)
        return Batch(gi, bi, len(g.coords) // b, patches, offsets, valid.copy())

    def __iter__(self) -> Iterator[Batch]:
        plan = self.plan
        work = [(gi, bi) for gi, g in enumerate(plan.groups)
                if gi not in self.skip_groups
                for bi in range(len(g.coords) // plan.batch)]
        out: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for gi, bi in work:
                        if stop.is_set():
                            return
                        out.put(self._assemble(pool, gi, bi))
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                out.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                yield item
            if self._err is not None:
                raise self._err
        finally:
            stop.set()
            # drain so the producer can finish putting and exit
            while t.is_alive():
                try:
                    out.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
