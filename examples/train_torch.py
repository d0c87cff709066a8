#!/usr/bin/env python
"""Fine-tune a segmentation model on annotated slides with the PyTorch port.

The twin of ``examples/train.py`` on ``digipathai_tpu_torch``: tissue
patches are sampled with the port's planner, labels come from a ``-gt``
slide, each step is the port's train step (``training/train.py``) on the
card (``--device cuda``, the default) or the CPU, and the result is saved
into the port's converted-weights cache, so the port's ``getSegmentation``
picks it up on the next run.

    python examples/train_torch.py slide.tiff --gt slide-gt.tiff \\
        --model dense --mode colon --steps 200 --batch 16

Several devices in one process: with ``--device cuda`` and more than one
visible card, or a comma-separated ``--device`` list (``cpu,cpu,cpu,cpu``
fakes four devices), the step runs over a (dp, sp, mp) mesh of them
(``parallel/mesh.py``, ``training/train.py::shard_train_step``), as
``examples/train.py`` meshes every local device; ``--batch`` must divide
by dp, and the saved weights are the mesh's, gathered.

Data-parallel over processes: set ``DPAI_COORDINATOR=host:port``,
``DPAI_NUM_PROCESSES=N`` and ``DPAI_PROCESS_ID=i`` for each of N processes
(``parallel/distributed.py``); every process samples the same global batch
and steps on its 1/N of it (``--batch`` divisible by N), and process 0
saves.  With ``--device cuda`` process i takes card ``i % device_count``.

Patches keep the engine's transposed (x, y, c) orientation
(``engine/loader.py:_read_patch``) so the fine-tuned weights match
inference exactly.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np


def sample_coords(plan, n: int, seed: int) -> np.ndarray:
    """(n, 2) level-0 patch top-lefts drawn from the tissue plan."""
    coords = np.concatenate([g.coords[g.valid] for g in plan.groups])
    if not len(coords):
        raise SystemExit("no tissue patches found in the slide")
    rng = np.random.default_rng(seed)
    return coords[rng.integers(0, len(coords), n)]


def read_batch(slide, gt, coords, patch: int):
    """uint8 (B, P, P, 3) patches + one-hot (B, P, P, 2) labels, both in the
    engine's (x, y, c) orientation."""
    x = np.empty((len(coords), patch, patch, 3), np.uint8)
    y = np.empty((len(coords), patch, patch), np.int64)
    for i, (cx, cy) in enumerate(coords):
        x[i] = slide.read_region((int(cx), int(cy)), 0,
                                 (patch, patch)).transpose(1, 0, 2)
        lab = gt.read_region((int(cx), int(cy)), 0, (patch, patch))
        y[i] = (lab[:, :, 0] > 127).T
    return x, np.eye(2, dtype=np.float32)[y]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("slide")
    ap.add_argument("--gt", default=None,
                    help="ground-truth slide (defaults to <stem>-gt.<ext>)")
    ap.add_argument("--model", default="dense",
                    choices=["dense", "inception", "deeplabv3", "tiny"])
    ap.add_argument("--mode", default="colon",
                    choices=["colon", "liver", "breast"])
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every visible card), cpu, or a "
                         "comma-separated list of devices for a mesh")
    ap.add_argument("--from-scratch", action="store_true",
                    help="random init instead of the pretrained checkpoint")
    ap.add_argument("--out", default=None,
                    help="output .npz (default: the port's converted cache, "
                         "so getSegmentation uses the result)")
    return ap.parse_args(argv)


def train(args):
    """Fine-tune as ``args`` says -> (the train state, a ``MeshState`` on
    a mesh; the saved path or None on a process other than 0)."""
    import torch

    from digipathai_tpu_torch.engine.planner import plan_patches
    from digipathai_tpu_torch.io.slide import Slide
    from digipathai_tpu_torch.models import weights as weights_lib
    from digipathai_tpu_torch.models.registry import build_model
    from digipathai_tpu_torch.ops.color import normalize_patches
    from digipathai_tpu_torch.parallel import distributed as dist
    from digipathai_tpu_torch.parallel.inference import make_dp_devices
    from digipathai_tpu_torch.parallel.mesh import make_mesh
    from digipathai_tpu_torch.training.train import (
        TrainState, make_dp_train_step, make_optimizer, make_train_step,
        shard_state, shard_train_step, unshard)

    stem, ext = os.path.splitext(args.slide)
    gt_path = args.gt or f"{stem}-gt{ext}"
    if not os.path.exists(gt_path):
        raise SystemExit(f"ground truth not found: {gt_path}")

    names = args.device.split(",")
    dist.initialize(device=names[0])
    rank, world = dist.process_index(), dist.process_count()
    if args.batch % world:
        raise SystemExit(f"--batch must be divisible by the {world} "
                         f"processes")
    mesh = None
    if not os.environ.get("DPAI_COORDINATOR"):
        local = make_dp_devices(device=names if len(names) > 1 else names[0])
        if len(local) > 1:
            mesh = make_mesh(devices=local)
    device = mesh.flat()[0] if mesh else torch.device(names[0])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    slide, gt = Slide(args.slide), Slide(gt_path)
    try:
        plan = plan_patches(slide, patch=args.patch, stride=args.patch // 2,
                            batch=args.batch)
        if rank == 0:
            print(f"{plan.total_patches} tissue patches at stride "
                  f"{args.patch // 2}")

        bundle = build_model(args.model)
        if args.from_scratch or args.model == "tiny":  # tiny: tests only
            model = bundle.init(args.patch, seed=args.seed)
        else:
            model = weights_lib.load_variables(bundle, args.mode, args.model,
                                               args.patch)
        model = model.to(device)
        state = TrainState(model, make_optimizer(model.parameters(),
                                                 args.lr))
        if mesh:
            print(f"mesh: {mesh.shape}")
            if args.batch % mesh.shape["dp"]:
                raise SystemExit(f"--batch must be divisible by "
                                 f"dp={mesh.shape['dp']}")
            state, step = shard_state(state, mesh), shard_train_step(mesh)
        elif world > 1:
            print(f"process {rank} of {world}: data-parallel on {device}")
            step = make_dp_train_step()
        else:
            step = make_train_step()
        generator = torch.Generator(device=device).manual_seed(
            args.seed + rank)  # DeepLab's dropout masks
        share = slice(rank * args.batch // world,
                      (rank + 1) * args.batch // world)

        t0 = time.time()
        for i in range(args.steps):
            coords = sample_coords(plan, args.batch, args.seed + i)[share]
            xb, yb = read_batch(slide, gt, coords, args.patch)
            x = normalize_patches(torch.from_numpy(xb).to(device),
                                  torch.float32)
            y = torch.from_numpy(yb).to(device)
            loss = step(state, x, y, generator=generator
                        if args.model == "deeplabv3" else None)
            if rank == 0 and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:4d}  loss {float(loss):.4f}  "
                      f"{time.time() - t0:.1f}s")
    finally:
        slide.close()
        gt.close()

    out = None
    if rank == 0:
        out = args.out or str(weights_lib.converted_path(args.mode,
                                                         args.model))
        weights_lib.save_converted(unshard(state) if mesh else state.model,
                                   Path(out))
        print(f"saved fine-tuned weights -> {out}")
    dist.barrier()
    return state, out


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
