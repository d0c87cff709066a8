"""The train step (``digipathai_tpu/training/train.py``) in PyTorch's idiom.

One step is a forward in train mode (the model's compute dtype, f32
parameters), the f32 CE + Dice loss, backward and adam; the BatchNorms'
running statistics move in place.  No kernel runs in train mode: the
models take JAX's canonical path, as JAX's ``not train`` gates do.

``make_dp_train_step`` is the data-parallel step over a ``torch.distributed``
process group (``parallel/distributed.py``), each rank holding its share of
the global batch: the multi-host path.  It computes what the serial step
computes on the whole batch, as JAX's GSPMD step does: the BatchNorm
statistics and the Dice term come from global sums (one differentiable
all-reduce each), and the gradients are averaged over the ranks.

``shard_train_step`` is JAX's ``shard_train_step``: the step over a (dp,
sp, mp) mesh of devices in one process (``parallel/mesh.py``).  Each mesh
device runs its replica on its batch shard's rows of its strip, one thread
per device in lockstep (``parallel/spatial.py``): the convs exchange halo
rows along sp, the convs of sharded kernels compute their output-channel
slices and gather them along mp (``parallel/channels.py``), and the
BatchNorm statistics and the loss come from sums over every batch shard
and strip (``spatial.batch_sum``).  That builds one autograd graph over
the mesh, and one ``backward()`` walks it; each parameter's gradient is
then the sum over its copies, and one adam steps every slice.  The loss
and the model that ``unshard`` gives are the serial step's.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.bridge import _flatten
from ..models.unet_decoder import BatchNorm
from ..parallel import channels, spatial
from ..parallel import mesh as mesh_lib
from .losses import (ce_sums, dice_sums, loss_from_sums, make_optimizer,
                     segmentation_loss)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_state(bundle, patch_size: int = 256, learning_rate: float = 1e-4,
               seed: int = 0, device="cuda") -> TrainState:
    """The bundle's seeded init on ``device`` and a fresh adam."""
    model = bundle.init(patch_size, seed=seed).to(device)
    return TrainState(model, make_optimizer(model.parameters(),
                                            learning_rate))


def _forward(model, x, generator):
    return model(x) if generator is None else model(x, generator=generator)


def _apply(state, loss_fn):
    """One step of ``state`` on the loss ``loss_fn(model)``: train mode,
    backward, eval mode again -> the loss, detached.  The caller steps the
    optimizer."""
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    model.train()
    try:
        loss = loss_fn(model)
        loss.backward()
    finally:
        model.eval()
    return loss.detach()


def make_train_step():
    """``step(state, x, y, generator=None) -> loss``: x (N, H, W, 3)
    normalized patches and y (N, H, W, 2) one-hot labels on the model's
    device; ``generator`` draws DeepLab's dropout mask.  The learning rate
    is the optimizer's (``make_optimizer``).  The gradients stay in the
    parameters' ``.grad`` after the step."""

    def step(state: TrainState, x, y, generator=None):
        loss = _apply(state, lambda m: segmentation_loss(
            _forward(m, x, generator), y))
        state.optimizer.step()
        state.step += 1
        return loss

    return step


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over every rank whose backward all-reduces the
    gradient: with every rank's objective summed, the gradient of a rank's
    contribution is the sum of every rank's gradient of the total."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


@contextmanager
def _global_batch_norm(model: nn.Module):
    """Every BatchNorm of ``model`` takes its statistics over every rank
    while the context is open."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.reduce = _SumOverRanks.apply
    try:
        yield
    finally:
        for m in bns:
            m.reduce = None


def _global_loss(probs, y):
    """The loss of the whole batch from this rank's share of it: the CE and
    Dice sums over every rank (one differentiable all-reduce)."""
    s = _SumOverRanks.apply(torch.cat([ce_sums(probs, y),
                                       dice_sums(probs, y)]))
    return loss_from_sums(s[:2], s[2:])


def make_dp_train_step():
    """The data-parallel ``step(state, x, y, generator=None) -> loss`` over
    the initialized default process group.  x and y are this rank's share
    of the global batch; every rank starts from the same state (the same
    seed or checkpoint) and keeps it equal.  The loss and the new state are
    the serial step's on the global batch: BatchNorm statistics over every
    rank, the loss from global sums, and each rank's gradient of that loss
    averaged over the ranks (each rank's backward counts the all-reduced
    terms once per rank).  DeepLab's dropout draws from each rank's own
    ``generator``."""
    world = dist.get_world_size()

    def step(state: TrainState, x, y, generator=None):
        with _global_batch_norm(state.model):
            loss = _apply(state, lambda m: _global_loss(
                _forward(m, x, generator), y))
        params = [p for p in state.model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        flat /= world
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))
        state.optimizer.step()
        state.step += 1
        return loss

    return step


@dataclass
class MeshState:
    """The train state over a mesh: one replica per mesh device, in rank
    order (``mesh.shard_variables``), one adam over every distinct
    parameter tensor (each holds its slice's moments), and the serial model
    the state was sharded from, into which ``unshard`` writes.  ``copies``:
    the tensors of one parameter slice on different devices, whose
    gradients the step sums."""
    mesh: mesh_lib.Mesh
    replicas: list
    optimizer: torch.optim.Optimizer
    model: nn.Module
    step: int = 0
    copies: list = field(default_factory=list)


def shard_state(state: TrainState, mesh: mesh_lib.Mesh) -> MeshState:
    """``state`` on ``mesh``: its model sharded by ``mesh.param_spec``, its
    learning rate, and its adam moments (if it has stepped) sliced as the
    parameters are."""
    replicas = mesh_lib.shard_variables(state.model, mesh)
    seen, groups = {}, {}
    for r in replicas:
        for k, p in r.named_parameters():
            if id(p) not in seen:
                seen[id(p)] = (k, p)
                m = getattr(p, channels.SLICE, (None,))[0]
                groups.setdefault((k, m), []).append(p)
    opt = make_optimizer([p for _, p in seen.values()],
                         state.optimizer.param_groups[0]["lr"])
    named = dict(state.model.named_parameters())
    for k, p in seen.values():
        old = state.optimizer.state.get(named[k])
        if old:
            m, mp = getattr(p, channels.SLICE, (0, 1))
            opt.state[p] = {key: v.clone() if key == "step" else
                            mesh_lib._piece(v, m, mp, mp > 1, p.device)
                            for key, v in old.items()}
    return MeshState(mesh, replicas, opt, state.model, state.step,
                     [g for g in groups.values() if len(g) > 1])


def unshard(ms: MeshState) -> nn.Module:
    """The serial model, its leaves set to the mesh's."""
    return mesh_lib.gather_variables(ms.replicas, ms.mesh, ms.model)


def _sum_copies(copies):
    """Set each group of copies' gradients to their sum (in group order,
    on the first copy's device)."""
    for group in copies:
        grads = [p.grad for p in group if p.grad is not None]
        if not grads:
            continue
        dev = group[0].device
        total = grads[0].to(dev, copy=True)
        for g in grads[1:]:
            total += g.to(dev)
        for p in group:
            p.grad = total if p.device == dev else total.to(p.device)


def shard_train_step(mesh: mesh_lib.Mesh):
    """The step over ``mesh``: ``step(ms, x, y, generator=None) -> loss``
    on a ``MeshState`` (``shard_state``).  x (N, H, W, 3) and y (N, H, W,
    2) are the global batch on any device; N must divide by dp and H by
    32 * sp (the deepest level's rows over the strips, as JAX's dry run
    sizes it), or ``ValueError``.  Device (d, s, m) takes batch shard d's
    rows of strip s.  DeepLab's dropout draws the serial step's mask for
    the global batch from ``generator`` once.  The step's threads (one per
    mesh device) live as long as the step: ``step.close()`` ends them."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    devices = mesh.flat()
    places = mesh.places()
    threads = spatial.StripThreads(mesh.size)

    def work(model, block, generator):
        xb, yb = block
        probs = _forward(model, xb, generator)
        s = spatial.batch_sum(torch.cat([ce_sums(probs, yb),
                                         dice_sums(probs, yb)]))
        return loss_from_sums(s[:2], s[2:])

    def step(ms: MeshState, x, y, generator=None):
        n, h = x.shape[:2]
        if n % dp:
            raise ValueError(f"a batch of {n} does not split over dp={dp}")
        if h % (32 * sp):
            raise ValueError(f"height {h} is not a multiple of 32 * sp = "
                             f"{32 * sp}")
        b = n // dp
        rows = spatial.partition(h, sp)
        blocks = []
        for r, dev in enumerate(devices):
            d, s, _ = mesh.coords(r)
            at = (slice(d * b, (d + 1) * b), slice(*rows[s]))
            blocks.append((x[at].to(dev), y[at].to(dev)))
        ms.optimizer.zero_grad(set_to_none=True)
        for r in ms.replicas:
            r.train()
        try:
            loss = threads.run_grid(
                lambda m, blk: work(m, blk, generator), ms.replicas, blocks,
                devices, places)[0]
            loss.backward()
        finally:
            for r in ms.replicas:
                r.eval()
        _sum_copies(ms.copies)
        ms.optimizer.step()
        ms.step += 1
        return loss.detach()

    step.close = threads.close
    weakref.finalize(step, threads.close)
    return step


def adam_state_from_optax(opt_state, state: TrainState) -> TrainState:
    """Carry optax's adam state into ``state.optimizer``, by parameter name
    (``bridge.flax_to_torch``'s ``<layer>.<leaf>``).  ``opt_state``: what
    ``optax.adam(...).init``/``update`` returns (its ``ScaleByAdamState``
    with ``count``, ``mu`` and ``nu``), as numpy trees.  Every parameter
    must have a moment, or ``KeyError``."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    named = dict(state.model.named_parameters())
    if set(named) != set(mu):
        raise KeyError(f"adam_state_from_optax: names do not match: "
                       f"{sorted(set(named) ^ set(mu))[:5]}")
    opt = state.optimizer
    for name, p in named.items():
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(adam.count)),
                                 dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32),
                                       device=p.device)}
    return state

