"""Keras auto-name allocator.

Keras's functional API assigns unnamed layers sequential per-class names
(``conv2d``, ``conv2d_1``, ..., ``batch_normalization``, ...) in creation
order; named layers don't consume the counter.  Our flax modules mirror those
names so ``convert_h5`` can map reference checkpoints layer-by-layer.
"""

from __future__ import annotations


class KerasNamer:
    def __init__(self):
        self._counters: dict[str, int] = {}

    def next(self, cls: str) -> str:
        i = self._counters.get(cls, 0)
        self._counters[cls] = i + 1
        return cls if i == 0 else f"{cls}_{i}"

    def conv(self) -> str:
        return self.next("conv2d")

    def bn(self) -> str:
        return self.next("batch_normalization")
