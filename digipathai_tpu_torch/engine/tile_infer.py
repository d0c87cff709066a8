"""Fully convolutional supertile inference (tile mode) on PyTorch.

Port of ``digipathai_tpu/engine/tile_infer.py``.  Patch mode computes
every tissue pixel about 4 times (256 px patches at stride 128); tile mode
runs ONE forward per model x TTA over each tissue supertile plus a halo of
``patch // 2`` px and keeps the interior.  At supertile 4096 that is one
(1, 4352, 4352, 3) forward, and with ``fused_stages`` the DenseNet decoder
runs each of its stages as one ``fused_up_stage`` kernel (the model routes
N == 1 inputs there).

Interior pixels match the patch-mode overlap-add up to the models'
patch-border padding effects (pointwise models match exactly).  The maps
are written directly (count = 1): supertiles do not overlap.

Several devices, two schemes, chosen by ``spatial_shard`` as JAX
chooses:

- round-robin: supertiles are independent, so they are dealt over the
  devices, each with a model replica of its own, and each result is
  flushed (and CRF-refined) by a writer pool.  Each supertile is computed
  as on one device, so the maps equal the serial run's bit for bit;
- spatially sharded (``build_tile_step_sp``): ONE supertile on all
  devices at once, its rows split into one strip per device, every model
  run on the strips in lockstep through the row-halo exchange of
  ``parallel/spatial.py``.  It lowers a slide's latency when the slide has
  fewer tissue supertiles than devices, which would leave devices idle in
  the round-robin.  The maps are the one-device step's up to summation
  order: a strip's convs (their kernels' plans, cuDNN's algorithms) and
  DeepLab's global mean add in another order.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch

from ..ops import tta as tta_ops
from ..ops.color import normalize_patches


def _to_device(tile_u8, device):
    return torch.as_tensor(np.ascontiguousarray(tile_u8)).to(device)


def build_tile_step(bundles: Sequence, tta_list: Sequence[str],
                    tile: int, halo: int, compute_dtype=torch.bfloat16,
                    faithful_tta: bool = False, device="cuda"):
    """Returns ``step(variables_list, tile_u8) -> (mean, var)`` over the
    tile's interior, every model x TTA prediction in one step;
    ``tile_u8`` is (tile + 2*halo, tile + 2*halo, 3) in (x, y, c)
    orientation."""
    chains = tta_ops.effective_transforms(tta_list, faithful=faithful_tta)

    def step(variables_list, tile_u8):
        with torch.inference_mode():
            x = normalize_patches(_to_device(tile_u8, device)[None],
                                  dtype=compute_dtype)
            preds = []
            for bundle, variables in zip(bundles, variables_list):
                for chain in chains:
                    p = bundle.apply_p1(variables,
                                        tta_ops.apply_chain(x, chain))
                    # center-crop the halo; a center crop of a square
                    # commutes with every dihedral TTA inversion
                    ch = (p.shape[-1] - tile) // 2
                    if ch:
                        p = p[:, ch:-ch, ch:-ch]
                    inv = chain[-1] if chain else tta_ops.DEFAULT
                    preds.append(tta_ops.invert(p, inv)[0])
            stack = torch.stack(preds)
            mean = stack.mean(0)
            var = stack.var(0, unbiased=False)
            return mean.float(), var.float()

    return step


def build_model_tile_steps(bundles: Sequence, tta_list: Sequence[str],
                           tile: int, halo: int,
                           compute_dtype=torch.bfloat16,
                           faithful_tta: bool = False,
                           tta_batch: int = 1, device="cuda"):
    """Per-model tile steps and a combine step (the big-tile path).

    Each ``steps[i](variables, tile_u8) -> (sum, sumsq)`` gives the f32 sum
    and sum of squares of its model's TTA predictions over the tile
    interior; ``combine(sums, sqs) -> (mean, var)`` turns the per-model
    lists into the mean and ``max(var, 0)``.  One model's activations are
    alive at a time.  ``tta_batch=B`` runs the TTA forwards B at a time
    (all dihedral transforms of a square tile share one shape); a batch of
    B > 1 is not a single supertile, so ``fused_stages`` models run their
    canonical decoder there, as in JAX.

    Returns ``(steps, combine, n_preds)``.
    """
    chains = tta_ops.effective_transforms(tta_list, faithful=faithful_tta)

    def make_step(bundle):
        def step(variables, tile_u8):
            with torch.inference_mode():
                x = normalize_patches(_to_device(tile_u8, device)[None],
                                      dtype=compute_dtype)
                xts = [tta_ops.apply_chain(x, c) for c in chains]
                b = max(1, min(tta_batch, len(chains)))
                preds = []
                for i in range(0, len(xts), b):
                    p = bundle.apply_p1(variables, torch.cat(xts[i:i + b]))
                    # crop whatever halo margin the model did not crop
                    ch = (p.shape[-1] - tile) // 2
                    if ch:
                        p = p[:, ch:-ch, ch:-ch]
                    preds.extend(p.float())
                return sum_predictions(preds, chains)
        return step

    n_preds = len(bundles) * len(chains)
    return [make_step(b) for b in bundles], make_combine(n_preds), n_preds


def sum_predictions(preds, chains):
    """(sum, sum of squares) of one model's per-chain predictions (each
    (H, W), halo cropped), each inverted by its chain's last transform."""
    s = sq = None
    for p, chain in zip(preds, chains):
        inv = chain[-1] if chain else tta_ops.DEFAULT
        p = tta_ops.invert(p[None], inv)[0]
        s = p if s is None else s + p
        sq = p * p if sq is None else sq + p * p
    return s, sq


def make_combine(n_preds: int):
    """``combine(sums, sqs) -> (mean, max(var, 0))`` over the per-model
    lists of ``sum_predictions``, summed in model order."""
    def combine(sums, sqs):
        s, q = sums[0], sqs[0]
        for a, b in zip(sums[1:], sqs[1:]):
            s = s + a
            q = q + b
        mean = s / n_preds
        var = q / n_preds - mean * mean
        return mean, torch.clamp(var, min=0.0)

    return combine


def build_tile_step_sp(bundles: Sequence, tta_list: Sequence[str],
                       tile: int, halo: int, devices,
                       compute_dtype=torch.bfloat16,
                       faithful_tta: bool = False):
    """The spatially sharded tile step: ONE supertile on all ``devices``
    (JAX's ``build_tile_step_sp``, whose ``sp`` mesh axis is the device
    list here; a list may repeat a device).

    Returns ``step(vars_on, tile_u8) -> (mean, var)`` on ``devices[0]``;
    ``vars_on[k]`` is the list of modules (one per bundle) on
    ``devices[k]``, as ``parallel/inference.py::replicas`` makes it, and
    ``tile_u8`` the (tile + 2*halo)^2 x 3 uint8 tile in (x, y, c)
    orientation.  Each TTA chain is applied to the whole normalized tile
    on ``devices[0]``; its rows are split into one strip per device
    (``parallel/spatial.py::shard_rows``), every strip runs its replica in
    lockstep on the step's strip threads (``StripThreads``, which live as
    long as the step: ``step.close()`` ends them), and the strips'
    predictions come back to ``devices[0]``, where they are cropped,
    inverted, summed per model and combined as the one-device
    ``build_model_tile_steps`` does.
    """
    import weakref

    from ..parallel import spatial

    chains = tta_ops.effective_transforms(tta_list, faithful=faithful_tta)
    devices = [torch.device(d) for d in devices]
    combine = make_combine(len(bundles) * len(chains))
    threads = spatial.StripThreads(len(devices))

    def step(vars_on, tile_u8):
        with torch.inference_mode():
            x = normalize_patches(_to_device(tile_u8, devices[0])[None],
                                  dtype=compute_dtype)
            sums, sqs = [], []
            for i, bundle in enumerate(bundles):
                replicas = [v[i] for v in vars_on]
                preds = []
                for chain in chains:
                    shards = spatial.shard_rows(
                        tta_ops.apply_chain(x, chain), devices)
                    p = spatial.unshard(threads.run(
                        bundle.apply_p1, replicas, shards), devices[0])
                    ch = (p.shape[-1] - tile) // 2
                    if ch:
                        p = p[:, ch:-ch, ch:-ch]
                    preds.append(p[0].float())
                s, q = sum_predictions(preds, chains)
                sums.append(s)
                sqs.append(q)
            return combine(sums, sqs)

    step.close = threads.close
    weakref.finalize(step, threads.close)
    return step


def fetch_window(coords_valid, ox, oy, S, halo, buckets, wx0, wy0,
                 mean_shape):
    """Window of a flushed supertile result that goes to the host.

    Returns ``(rx0, ry0, bx, by)`` in supertile coordinates.  Under bbox
    compute the result is the compute window itself and is fetched whole;
    otherwise it is the tissue bbox plus the halo write fringe, rounded up
    to one of ``buckets``.  The window decides which pixels a flush writes.
    """
    if mean_shape[0] < S:
        return wx0, wy0, int(mean_shape[0]), int(mean_shape[1])
    c = coords_valid
    patch = 2 * halo
    rx0 = max(0, int(c[:, 0].min() - ox) - halo)
    ry0 = max(0, int(c[:, 1].min() - oy) - halo)
    sx = min(S, int(c[:, 0].max() - ox) + patch + halo) - rx0
    sy = min(S, int(c[:, 1].max() - oy) + patch + halo) - ry0
    bx = next(b for b in buckets if b >= sx)
    by = next(b for b in buckets if b >= sy)
    return min(rx0, S - bx), min(ry0, S - by), bx, by


def run_tile_inference(slide, plan, bundles, variables_tuple, tta_full,
                       mean_map, var_map, count_map, *, halo: int,
                       status=None, timer=None, progress_cb=None,
                       compute_dtype=torch.bfloat16, completed=None,
                       on_group_done=None, faithful_tta: bool = False,
                       spatial_shard="auto", crf_cb=None,
                       bbox_compute: bool = False, state_lock=None,
                       devices=("cuda",)):
    """Segment every tissue supertile of ``plan`` fully convolutionally.

    The patch plan's supertile groups serve as the tissue index (a group
    exists iff its supertile holds strided tissue).  Group i goes to
    ``devices[i % D]``: its tile plus halo is read (zero-filled out of
    bounds), transposed to (x, y, c), run through the per-model steps and
    ``combine`` on that device, and handed to a flusher pool of
    ``max(2, D)`` threads that writes mean, var and count = 1 into the
    host memmaps, marks the group completed (under ``state_lock``) and
    calls ``on_group_done``.  ``variables_tuple`` holds the modules on
    ``devices[0]``; every further device (a repeated one included) gets a
    replica of its own (``parallel/inference.py::replicate``).

    Timer stages: ``read`` (the slide region) and ``infer`` (upload and
    launches; the forward runs asynchronously) in this thread; ``wait``
    (until the supertile's forward has finished on the card), ``flush``
    (device-to-host copy, transposes, memmap writes) and ``crf`` in the
    flusher threads, summed over them.

    ``crf_cb(group, img_tile, device)`` runs at flush, after the
    completion mark, under the ``crf`` timer stage: a supertile's mean is
    final then, so the CRF overlaps the next supertile's read and forward,
    on the device that computed the supertile.  ``img_tile`` is the
    (supertile, supertile, 3) region already read, halo cropped.

    ``bbox_compute=True`` runs the forward on the tissue bbox padded up to
    one of three square compute buckets instead of the whole supertile,
    keeping the same halo context, so written pixels keep the same
    receptive-field semantics.

    ``spatial_shard`` chooses the scheme by JAX's rule: sharding is
    possible when D > 1 and ``(S + 2*halo) % D == 0``; True then shards
    (and raises JAX's ``ValueError`` where it is not possible), ``"auto"``
    shards when fewer supertiles are left than devices, False deals
    round-robin.  Sharded (``build_tile_step_sp``), each supertile is the
    full tile (``bbox_compute`` does not apply), computed on all devices
    with its result on ``devices[0]``; a flusher pool of 2 keeps at most 2
    supertiles in flight, and ``crf_cb`` runs on ``devices[0]``.
    """
    from ..parallel.inference import on_device, replicas

    X, Y = plan.slide_dims
    S = plan.supertile
    completed = completed if completed is not None else set()
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    todo = [(gi, g) for gi, g in enumerate(plan.groups)
            if gi not in completed]
    # sharding pays off when devices would otherwise idle (fewer supertiles
    # than devices); the sharded axis must split the padded tile evenly
    sp_possible = n_dev > 1 and (S + 2 * halo) % n_dev == 0
    if spatial_shard is True and not sp_possible:
        # an explicit True must not silently run something else
        raise ValueError(
            f"spatial_shard=True needs >1 device and (supertile + patch_"
            f"size) % n_devices == 0; got {n_dev} device(s), padded tile "
            f"{S + 2 * halo}. Use spatial_shard='auto' for automatic "
            f"fallback.")
    use_sp = sp_possible and (
        spatial_shard is True
        or (spatial_shard == "auto" and len(todo) < n_dev))
    vars_on = replicas(variables_tuple, devices)

    @functools.lru_cache(maxsize=None)
    def get_steps(dev, b):
        return build_model_tile_steps(
            bundles, tta_full, b, halo, compute_dtype=compute_dtype,
            faithful_tta=faithful_tta, device=dev)[:2]

    # square compute buckets (TTA rotations need square tiles), aligned to
    # the models' /32 stride tree like the supertile itself
    cbuckets = [b for b in sorted({min(S, -(-S // 4 // 32) * 32),
                                   min(S, -(-S // 2 // 32) * 32), S})
                if (b + 2 * halo) % 32 == 0]
    if not bbox_compute or cbuckets[-1] != S or len(cbuckets) == 1:
        cbuckets = [S]
    total = max(len(plan.groups), 1)
    done = len(completed)
    lock = state_lock if state_lock is not None else threading.Lock()
    # bucketed tissue-bbox fetch: sparse supertiles move a fraction of the
    # S^2 result planes to the host
    buckets = sorted({(S + 3) // 4, (S + 1) // 2, S})

    def stage(name):
        return timer.stage(name) if timer else nullcontext()

    def flush(mean, var, ready, gi, g, region, wx0, wy0, dev):
        # mean/var cover the supertile window starting at (wx0, wy0): the
        # full tile by default, the bbox bucket under bbox_compute
        nonlocal done
        ox, oy = g.origin
        w = min(S, X - ox)
        h = min(S, Y - oy)
        rx0, ry0, bx, by = fetch_window(
            g.coords[g.valid], ox, oy, S, halo, buckets, wx0, wy0,
            tuple(mean.shape))
        copy_stream = nullcontext()
        if ready is not None:
            # wait for this supertile's forward alone, then copy on a side
            # stream: the default stream may already hold the next forward
            with stage("wait"):
                ready.synchronize()
            copy_stream = torch.cuda.stream(torch.cuda.Stream(mean.device))
        with stage("flush"), copy_stream:
            x0, y0 = rx0 - wx0, ry0 - wy0
            mean_h = mean[x0:x0 + bx, y0:y0 + by].cpu().numpy()
            var_h = var[x0:x0 + bx, y0:y0 + by].cpu().numpy()
            # maps are (Y, X); tile arrays are (x, y)
            wy = min(by, h - ry0)
            wx = min(bx, w - rx0)
            my, mx = oy + ry0, ox + rx0
            mean_map[my:my + wy, mx:mx + wx] = mean_h[:wx, :wy].T
            var_map[my:my + wy, mx:mx + wx] = var_h[:wx, :wy].T
            count_map[my:my + wy, mx:mx + wx] = 1.0
        with lock:
            done += 1
            completed.add(gi)
            if on_group_done is not None:
                on_group_done(gi)
            if status is not None:
                status["progress"] = int(done * 100.0 / total)
            if progress_cb is not None:
                progress_cb(done, total)
        if crf_cb is not None:
            # after the completion mark: a crash mid-CRF resumes into the
            # engine's post-pass instead of re-inferring the tile
            with stage("crf"):
                crf_cb(g, region[halo:halo + S, halo:halo + S], dev)

    def read(g):
        ox, oy = g.origin
        with stage("read"):
            # tile + halo, (y, x, c); Slide zero-fills out of bounds
            return slide.read_region((ox - halo, oy - halo), 0,
                                     (S + 2 * halo, S + 2 * halo))

    def submit(flusher, pending, mean, var, gi, g, region, wx0, wy0, dev,
               depth):
        ready = None
        if mean.is_cuda:
            with on_device(dev):
                ready = torch.cuda.Event()
                ready.record()
        pending.append(flusher.submit(flush, mean, var, ready, gi, g,
                                      region, wx0, wy0, dev))
        # each pending result pins device and host buffers
        while len(pending) > depth:
            pending.pop(0).result()

    if use_sp:
        step_sp = build_tile_step_sp(
            bundles, tta_full, S, halo, devices, compute_dtype=compute_dtype,
            faithful_tta=faithful_tta)
        try:
            with ThreadPoolExecutor(2) as flusher:
                pending = []
                for gi, g in todo:
                    region = read(g)
                    with stage("infer"), on_device(devices[0]):
                        mean, var = step_sp(vars_on,
                                            np.transpose(region, (1, 0, 2)))
                    submit(flusher, pending, mean, var, gi, g, region, 0, 0,
                           devices[0], 2)
                for fut in pending:
                    fut.result()
        finally:
            step_sp.close()
        return

    with ThreadPoolExecutor(max(2, n_dev)) as flusher:
        pending = []
        for i, (gi, g) in enumerate(todo):
            k = i % n_dev
            dev = devices[k]
            ox, oy = g.origin
            # tissue-bbox compute window (a bucketed square with the same
            # halo write fringe the flush covers); the full tile otherwise
            wx0 = wy0 = 0
            b = S
            if len(cbuckets) > 1:
                c = g.coords[g.valid]
                patch = 2 * halo
                wx0 = max(0, int(c[:, 0].min() - ox) - halo)
                wy0 = max(0, int(c[:, 1].min() - oy) - halo)
                sx = min(S, int(c[:, 0].max() - ox) + patch + halo) - wx0
                sy = min(S, int(c[:, 1].max() - oy) + patch + halo) - wy0
                b = next(bk for bk in cbuckets if bk >= max(sx, sy))
                wx0 = min(wx0, S - b)
                wy0 = min(wy0, S - b)
            region = read(g)
            sub = region[wy0:wy0 + b + 2 * halo, wx0:wx0 + b + 2 * halo]
            tile_xyc = np.transpose(sub, (1, 0, 2))
            steps, combine = get_steps(dev, b)
            with stage("infer"), on_device(dev):
                sums, sqs = [], []
                for step, v in zip(steps, vars_on[k]):
                    s, q = step(v, tile_xyc)
                    sums.append(s)
                    sqs.append(q)
                mean, var = combine(sums, sqs)
            # about two supertiles per device in flight
            submit(flusher, pending, mean, var, gi, g, region, wx0, wy0, dev,
                   2 * n_dev)
        for fut in pending:
            fut.result()
