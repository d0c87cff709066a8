"""Device mesh and sharding rules (``digipathai_tpu/parallel/mesh.py``).

A (dp, sp, mp) mesh of torch devices, as JAX builds it:

- ``dp`` shards the patch batch (grid data parallelism),
- ``sp`` shards the rows of the activations (``parallel/spatial.py``
  writes out the halo exchanges that GSPMD inserts),
- ``mp`` shards the output channels of the convolutions
  (``parallel/channels.py`` writes out GSPMD's channel partitioning).

``factor_devices``, ``batch_spec`` and ``param_spec`` are JAX's rules.
The parameters keep flax's layouts (HWIO kernels, (C,) BatchNorm
leaves), so ``param_spec`` shards the same leaves as JAX's.
``shard_variables`` gives each mesh device a replica of the model holding
its mp slice of each sharded leaf (parameters and BatchNorm statistics,
as JAX places ``batch_stats`` too); ``gather_variables`` is its inverse.

A device list may repeat a device (``["cpu"] * 8``, ``["cuda:0"] * 4``):
each entry is then a mesh device of its own.  Replicas on one torch
device share one tensor per parameter slice, so the gradients of those
copies add up in autograd; the copies on other devices are summed by the
step (``training/train.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import channels, spatial

AXES = ("dp", "sp", "mp")


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Split n devices into (dp, sp, mp) with dp * sp * mp == n exactly.

    sp and mp take at most a factor of 2 each from n's power-of-2 part;
    everything else (including any odd factor) goes to dp.
    """
    pow2 = n & -n  # largest power of 2 dividing n
    sp = 2 if pow2 >= 2 else 1
    mp = 2 if pow2 >= 4 else 1
    dp = n // (sp * mp)
    assert dp * sp * mp == n
    return dp, sp, mp


class Mesh:
    """``devices``: an object array of ``torch.device`` shaped (dp, sp,
    mp); ``shape``: {axis: size}, as JAX's ``Mesh.shape``.  A device's rank
    is its index in C order, (d * sp + s) * mp + m."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> List[torch.device]:
        """The devices in rank order."""
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """(d, s, m) of a rank."""
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.devices.shape))

    def places(self) -> List[spatial.Place]:
        """Each device's ``spatial.Place`` in a lockstep run over the mesh:
        its row strips along sp, its channel slices along mp, its batch
        sums over dp and sp, its batch shard along dp."""
        dp, sp, mp = self.devices.shape
        ranks = np.arange(self.size).reshape(dp, sp, mp)

        def group(a):
            return tuple(int(r) for r in a.reshape(-1))

        out = []
        for r in range(self.size):
            d, s, m = self.coords(r)
            out.append(spatial.Place(r, group(ranks[d, :, m]),
                                     group(ranks[d, s, :]),
                                     group(ranks[:, :, m]), (d, dp)))
        return out

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``devices`` (default: every visible CUDA device; with
    none, ``ValueError``: there is no CPU fallback), its first
    ``n_devices`` when given, factored by ``factor_devices``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible (pass devices=, which "
                f"may repeat a device, e.g. ['cpu'] * {n_devices}, to fake "
                f"a topology)")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("no CUDA device is visible; pass devices= to "
                         "build a mesh of other devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(factor_devices(len(devices))))


def batch_spec() -> tuple:
    """(B, X, Y, C) patches: batch over dp, spatial X (rows) over sp."""
    return ("dp", "sp", None, None)


def param_spec(shape, mp_size: int) -> tuple:
    """Shard a leaf's last (output-channel) axis over mp if divisible and
    at least 8 * mp wide: (None, ..., "mp"), else () (replicated)."""
    if (len(shape) >= 1 and mp_size > 1 and shape[-1] % mp_size == 0
            and shape[-1] >= mp_size * 8):
        return (None,) * (len(shape) - 1) + ("mp",)
    return ()


def _leaves(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and (non-None) buffer of ``model`` by name."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def sharded_names(model: nn.Module, mp_size: int) -> List[str]:
    """The names of the leaves ``param_spec`` shards over ``mp_size``."""
    return [k for k, t in _leaves(model).items()
            if param_spec(t.shape, mp_size)]


def _piece(t: torch.Tensor, m: int, mp: int, sharded: bool, device,
           param: bool = False):
    """Slice m of mp of ``t``'s last axis (or all of it), a copy on
    ``device`` (an ``nn.Parameter`` with ``param``), marked for
    ``parallel/channels.py``."""
    t = t.detach()
    if sharded:
        c = t.shape[-1] // mp
        t = t[..., m * c:(m + 1) * c]
    t = t.to(device, copy=True).contiguous()
    if param:
        t = nn.Parameter(t)
    return channels.mark(t, m, mp) if sharded else t


def shard_variables(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One replica of ``model`` per mesh device, in rank order: on its
    device, holding its mp slice of every leaf ``param_spec`` shards and
    the whole of every other leaf.  Replicas on one device share their
    parameters (one tensor per device and slice, or per device for a
    leaf that is not sharded); each replica has buffers of its own."""
    mp = mesh.shape["mp"]
    sharded = set(sharded_names(model, mp))
    params = dict(model.named_parameters())
    shared = {}  # (name, device, slice index or None) -> Parameter
    replicas = []
    for rank, dev in enumerate(mesh.flat()):
        m = mesh.coords(rank)[2]
        memo = {}
        for k, p in params.items():
            key = (k, dev, m if k in sharded else None)
            if key not in shared:
                shared[key] = _piece(p, m, mp, k in sharded, dev, True)
            memo[id(p)] = shared[key]
        # prepared-operand caches start empty (parallel/inference.py)
        memo.update({id(sub._prepared): {} for sub in model.modules()
                     if isinstance(getattr(sub, "_prepared", None), dict)})
        replica = copy.deepcopy(model, memo)
        for k, b in list(replica.named_buffers()):
            owner, _, leaf = k.rpartition(".")
            replica.get_submodule(owner)._buffers[leaf] = _piece(
                b, m, mp, k in sharded, dev)
        replicas.append(replica)
    return replicas


def gather_variables(replicas: Sequence[nn.Module], mesh: Mesh,
                     into: nn.Module) -> nn.Module:
    """The inverse of ``shard_variables``: every leaf of ``into`` set to
    the mesh's value (a sharded leaf from the slices of the first mp
    group, in slice order; any other from the first replica), in place on
    ``into``'s devices.  Returns ``into``."""
    mp = mesh.shape["mp"]
    got = [_leaves(r) for r in replicas[:mp]]
    with torch.no_grad():
        for k, t in _leaves(into).items():
            if param_spec(t.shape, mp):
                t.copy_(torch.cat([g[k].to(t.device) for g in got], -1))
            else:
                t.copy_(got[0][k])
    return into


def gather_grads(replicas: Sequence[nn.Module],
                 mesh: Mesh) -> Dict[str, Optional[torch.Tensor]]:
    """Each parameter's gradient in the serial layout, on the first
    replica's device (sharded leaves from the first mp group's slices);
    None where the first replica's copy has none."""
    mp = mesh.shape["mp"]
    named = [dict(r.named_parameters()) for r in replicas[:mp]]
    dev = next(replicas[0].parameters()).device
    out = {}
    for k, p in named[0].items():
        if p.grad is None:
            out[k] = None
        elif getattr(p, channels.SLICE, None):
            out[k] = torch.cat([n[k].grad.to(dev) for n in named], -1)
        else:
            out[k] = p.grad
    return out
