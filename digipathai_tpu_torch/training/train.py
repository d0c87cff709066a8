"""The train step (``digipathai_tpu/training/train.py``) in PyTorch's idiom.

One step is a forward in train mode (the model's compute dtype, f32
parameters), the f32 CE + Dice loss, backward and adam; the BatchNorms'
running statistics move in place.  No kernel runs in train mode: the
models take JAX's canonical path, as JAX's ``not train`` gates do.

``make_dp_train_step`` is the data-parallel step over a ``torch.distributed``
process group (``parallel/distributed.py``), each rank holding its share of
the global batch.  It computes what the serial step computes on the whole
batch, as JAX's GSPMD step does: the BatchNorm statistics and the Dice
term come from global sums (one differentiable all-reduce each), and the
gradients are averaged over the ranks.  JAX's ``sp`` and ``mp`` axes
(spatial and channel sharding) are not ported.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.bridge import _flatten
from ..models.unet_decoder import BatchNorm
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

