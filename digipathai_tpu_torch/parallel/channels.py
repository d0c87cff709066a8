"""Output-channel sharding (the ``mp`` mesh axis), written out.

JAX's mesh (``digipathai_tpu/parallel/mesh.py``) shards the last axis of
every parameter that ``param_spec`` allows over ``mp`` (a conv kernel's
output channels, HWIO; a bias's or a BatchNorm's channels), and GSPMD
partitions each conv by its output channels and inserts the collectives.
Here each mp device's replica holds its slice of each such leaf
(``parallel/mesh.py::shard_variables`` marks it), and the models' ops call
this layer where a sharded leaf is used:

- ``gather(y, leaf)``: ``y`` is the output of a conv run with its sharded
  kernel (and bias), i.e. this device's slice of the output channels; the
  result is the whole output, the slices of the ``channels`` group
  concatenated in slice order.  So each conv computes only its slice,
  and the rest of the forward sees whole tensors, replicated over mp.
- ``whole(*leaves)``: the whole leaves (a BatchNorm's scale and bias, which
  apply to whole activations), gathered in one exchange.
- ``mine(t, leaf)``: this device's slice of a whole tensor: the input
  channels a depthwise conv's kernel slice reads (its channel ``c`` reads
  input channel ``c``), and the BatchNorm's running statistics, updated
  per slice.

Each gather is a differentiable ``torch.cat`` of the slices: in the
backward, slice j's gradient is the sum over the mp devices of their
gradients' slice j, which is the sum that the channel-split conv's input
gradient and a replicated leaf's gradient need.  Outside a lockstep run,
or on a leaf that is not sharded, every function returns its input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import spatial

SLICE = "_mp_slice"  # the attribute a sharded leaf carries: (index, count)


def mark(leaf: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Mark ``leaf`` as slice ``index`` of ``count`` along its last axis."""
    setattr(leaf, SLICE, (index, count))
    return leaf


def slice_of(leaf) -> Optional[Tuple[int, int]]:
    """(index, count) of a sharded leaf inside a lockstep run, else None."""
    if leaf is None or not spatial.sharded():
        return None
    return getattr(leaf, SLICE, None)


def _cat(posts, j, device):
    return torch.cat([spatial._on(p[j][0], p[j][1], device) for p in posts],
                     dim=-1)


def gather(y: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """The whole output of a conv whose kernel ``leaf`` may be sharded:
    ``y`` is this device's channel slice of it."""
    if slice_of(leaf) is None:
        return y
    posts, _ = spatial._exchange((y,), "channels")
    return _cat(posts, 0, y.device)


def whole(*leaves):
    """Each of ``leaves`` whole (None stays None); the sharded ones are
    gathered in one exchange."""
    sharded = [i for i, t in enumerate(leaves) if slice_of(t) is not None]
    if not sharded:
        return leaves
    posts, _ = spatial._exchange(tuple(leaves[i] for i in sharded),
                                 "channels")
    out = list(leaves)
    for j, i in enumerate(sharded):
        out[i] = _cat(posts, j, leaves[i].device)
    return tuple(out)


def mine(t: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """This device's slice of a whole ``t`` along the last axis, as
    ``leaf`` is sliced (``t`` itself where ``leaf`` is not sharded)."""
    s = slice_of(leaf)
    if s is None:
        return t
    c = leaf.shape[-1]
    return t[..., s[0] * c:(s[0] + 1) * c]
