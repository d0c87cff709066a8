"""Grid-dp inference: the patch grid split over a list of torch devices.

Port of ``digipathai_tpu/parallel/inference.py``.  A global batch of
``D * B`` patches is cut into D shards of B rows; shard k runs on device
``devices[k]`` with a model replica of its own: it normalizes its patches,
runs every model x TTA chain, takes the mean and variance and stitches them
into its own supertile accumulator.  Nothing crosses devices in the hot
loop.  At a supertile's flush ``reduce_accumulator`` sums the shards'
accumulators onto the first device in shard order.

JAX runs the shards under one ``shard_map`` program.  Here the shards'
steps are issued one after another from the caller's thread.  A batch-32
forward is bound by its host-side launches, so the loop serializes D such
forwards on the host; a thread per shard contends for the GIL instead,
and on one H100 holding two shards a global batch of 64 took twice as
long from two threads as from the loop (``chip_smoke.py`` phase 5a times
both; PERF.md section 5).  The patches go up from pinned memory without
blocking, so the host issues the next shard while the card runs the last
one.  A device list may
repeat a device: each entry is then one shard with its own replica and
accumulator (how the CPU tests fake a topology, and how one card runs two
shards).

Invariant (as in JAX): the maps equal the single-device engine's for the
same plan up to the f32 order of the overlap-add, because each shard's
batch is one of the serial run's batches and padding patches weigh 0.
"""

from __future__ import annotations

import copy
from contextlib import nullcontext
from typing import List, Sequence

import numpy as np
import torch

from ..engine.infer import build_step
from ..ops.stitch import make_accumulator


def make_dp_devices(n=None, device="cuda") -> List[torch.device]:
    """The devices of a grid-dp run, this process's only.

    ``device``: ``"cuda"`` without an index means every visible card (as
    ``jax.local_devices()`` does); ``"cuda:1"`` or ``"cpu"`` that one
    device; a sequence exactly those devices, repeats included.  ``n`` takes
    the first n and raises ``ValueError`` when fewer are named: a silent
    truncation would run "parallel" work on fewer devices with no signal.
    A CUDA device without CUDA raises ``RuntimeError``.
    """
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())] or [dev]
        else:
            devices = [dev]
    if not devices:
        raise ValueError("the device list is empty")
    if any(d.type == "cuda" for d in devices) and \
            not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested, but "
                           f"torch.cuda.is_available() is False")
    if n is not None:
        if len(devices) < n:
            raise ValueError(
                f"requested a {n}-device dp run but only {len(devices)} "
                f"device(s) are named by device={device!r} (pass a list "
                f"that repeats a device, e.g. ['cpu'] * {n}, to fake a "
                f"topology)")
        devices = devices[:n]
    return devices


def on_device(device: torch.device):
    """A context in which ``device`` is CUDA's current device (the one
    events and the kernels' streams are taken from); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


def replicate(module: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of ``module`` on ``device`` whose prepared-operand caches
    (``PreparedModule._prepared``) start empty, so it never holds or
    reuses another replica's operands.  Parameters, BatchNorm statistics
    and the static int8 ranges (``amax`` buffers) travel with it."""
    memo = {id(m._prepared): {} for m in module.modules()
            if isinstance(getattr(m, "_prepared", None), dict)}
    return copy.deepcopy(module, memo).to(device).eval()


def replicas(modules, devices) -> List[list]:
    """One list of modules per shard: ``modules`` themselves (on
    ``devices[0]``) for the first, a ``replicate`` on its device for every
    other shard."""
    return [list(modules)] + [[replicate(m, d) for m in modules]
                              for d in devices[1:]]


def shard_batch(devices: Sequence[torch.device], patches, offsets, valid):
    """Cut a global batch into ``len(devices)`` shards of B rows.  Returns
    one ``(patches on the device, offsets, valid)`` per shard: the patches
    go up from pinned memory without blocking, offsets and valid stay on
    the host, where the stitch reads them."""
    d = len(devices)
    patches = np.asarray(patches)
    if len(patches) % d:
        raise ValueError(f"a global batch of {len(patches)} patches does not "
                         f"split into {d} shards")
    b = len(patches) // d
    offsets, valid = np.asarray(offsets), np.asarray(valid)
    out = []
    for k, dev in enumerate(devices):
        rows = slice(k * b, (k + 1) * b)
        host = torch.from_numpy(np.ascontiguousarray(patches[rows]))
        if dev.type == "cuda":
            host = host.pin_memory()
        out.append((host.to(dev, non_blocking=True), offsets[rows],
                    valid[rows]))
    return out


def build_sharded_step(bundles: Sequence, tta_list: Sequence[str], patch: int,
                       devices: Sequence[torch.device],
                       faithful_tta: bool = False,
                       compute_dtype=torch.bfloat16,
                       mask_predictions: bool = False):
    """Returns ``step(replicas, accs, shards)``.

    ``replicas[k]`` is shard k's list of modules (one per bundle) on
    ``devices[k]``, ``accs[k]`` its accumulator, ``shards`` what
    ``shard_batch`` gave.  Each shard runs ``engine.infer.build_step``'s
    step for its device, one after another from the caller's thread.
    Returns ``accs`` once every shard's work is issued; it runs on
    asynchronously.
    """
    steps = [build_step(bundles, tta_list, patch, faithful_tta=faithful_tta,
                        compute_dtype=compute_dtype,
                        mask_predictions=mask_predictions, device=d)
             for d in devices]

    def step(replicas, accs, shards):
        for k, dev in enumerate(devices):
            with on_device(dev):
                steps[k](replicas[k], accs[k], *shards[k])
        return accs

    return step


def make_sharded_accumulator(devices: Sequence[torch.device], supertile: int,
                             patch: int, planes: int = 3):
    """One zeroed ``(planes, S + patch, S + patch)`` accumulator per shard."""
    return [make_accumulator(supertile, patch, planes=planes, device=d)
            for d in devices]


def reduce_accumulator(accs, window=(slice(None),)):
    """The shards' accumulators summed onto the first one's device, in
    shard order.  ``window`` (an index tuple) restricts the sum to that part
    of each accumulator: the flush fetches only the tissue bbox.  One
    accumulator is returned as a view."""
    out = accs[0][window]
    if len(accs) == 1:
        return out
    out = out.clone()
    for a in accs[1:]:
        out += a[window].to(out.device)
    return out

