"""Fully convolutional supertile inference (tile mode) on PyTorch.

Port of ``digipathai_tpu/engine/tile_infer.py`` for one device.  Patch
mode computes every tissue pixel about 4 times (256 px patches at stride
128); tile mode runs ONE forward per model x TTA over each tissue
supertile plus a halo of ``patch // 2`` px and keeps the interior.  At
supertile 4096 that is one (1, 4352, 4352, 3) forward, and with
``fused_stages`` the DenseNet decoder runs each of its stages as one
``fused_up_stage`` kernel (the model routes N == 1 inputs there).

Interior pixels match the patch-mode overlap-add up to the models'
patch-border padding effects (pointwise models match exactly).  The maps
are written directly (count = 1): supertiles do not overlap.  Multi-device
round-robin and the spatially sharded step are not ported yet.
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
                s = sq = None
                for p, chain in zip(preds, chains):
                    inv = chain[-1] if chain else tta_ops.DEFAULT
                    p = tta_ops.invert(p[None], inv)[0]
                    s = p if s is None else s + p
                    sq = p * p if sq is None else sq + p * p
                return s, sq
        return step

    n_preds = len(bundles) * len(chains)

    def combine(sums, sqs):
        s, q = sums[0], sqs[0]
        for a, b in zip(sums[1:], sqs[1:]):
            s = s + a
            q = q + b
        mean = s / n_preds
        var = q / n_preds - mean * mean
        return mean, torch.clamp(var, min=0.0)

    return [make_step(b) for b in bundles], combine, n_preds


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
                       device="cuda"):
    """Segment every tissue supertile of ``plan`` fully convolutionally.

    The patch plan's supertile groups serve as the tissue index (a group
    exists iff its supertile holds strided tissue).  For each group the
    tile plus halo is read (zero-filled out of bounds), transposed to
    (x, y, c), run through the per-model steps and ``combine`` on
    ``device``, and handed to a two-thread flusher that writes mean, var
    and count = 1 into the host memmaps, marks the group completed (under
    ``state_lock``) and calls ``on_group_done``.

    Timer stages: ``read`` (the slide region) and ``infer`` (upload and
    launches; the forward runs asynchronously) in this thread; ``wait``
    (until the supertile's forward has finished on the card), ``flush``
    (device-to-host copy, transposes, memmap writes) and ``crf`` in the
    flusher threads, summed over both.

    ``crf_cb(group, img_tile)`` runs at flush, after the completion mark,
    under the ``crf`` timer stage: a supertile's mean is final then, so the
    CRF overlaps the next supertile's read and forward.  ``img_tile`` is
    the (supertile, supertile, 3) region already read, halo cropped.

    ``bbox_compute=True`` runs the forward on the tissue bbox padded up to
    one of three square compute buckets instead of the whole supertile,
    keeping the same halo context, so written pixels keep the same
    receptive-field semantics.

    ``spatial_shard=True`` raises: one device cannot shard a tile.
    """
    X, Y = plan.slide_dims
    S = plan.supertile
    completed = completed if completed is not None else set()
    if spatial_shard is True:
        # one device: sp is never possible, and an explicit True must not
        # silently run something else
        raise ValueError(
            f"spatial_shard=True needs >1 device and (supertile + patch_"
            f"size) % n_devices == 0; got 1 device(s), padded tile "
            f"{S + 2 * halo}. Use spatial_shard='auto' for automatic "
            f"fallback.")
    todo = [(gi, g) for gi, g in enumerate(plan.groups)
            if gi not in completed]

    @functools.lru_cache(maxsize=None)
    def get_steps(b):
        return build_model_tile_steps(
            bundles, tta_full, b, halo, compute_dtype=compute_dtype,
            faithful_tta=faithful_tta, device=device)[:2]

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

    def flush(mean, var, ready, gi, g, region, wx0, wy0):
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
                crf_cb(g, region[halo:halo + S, halo:halo + S])

    with ThreadPoolExecutor(2) as flusher:
        pending = []
        for gi, g in todo:
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
            with stage("read"):
                # tile + halo, (y, x, c); Slide zero-fills out of bounds
                region = slide.read_region((ox - halo, oy - halo), 0,
                                           (S + 2 * halo, S + 2 * halo))
            sub = region[wy0:wy0 + b + 2 * halo, wx0:wx0 + b + 2 * halo]
            tile_xyc = np.transpose(sub, (1, 0, 2))
            steps, combine = get_steps(b)
            with stage("infer"):
                sums, sqs = [], []
                for step, v in zip(steps, variables_tuple):
                    s, q = step(v, tile_xyc)
                    sums.append(s)
                    sqs.append(q)
                mean, var = combine(sums, sqs)
                ready = None
                if mean.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record()
            pending.append(flusher.submit(flush, mean, var, ready, gi, g,
                                          region, wx0, wy0))
            # each pending result pins device and host buffers
            while len(pending) > 2:
                pending.pop(0).result()
        for fut in pending:
            fut.result()
