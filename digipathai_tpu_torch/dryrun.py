"""Compile check and multi-device dry run (``__graft_entry__.py``).

``entry()`` is the flagship forward the port's users run: the
DenseNet121-U-Net in bf16 over a batch of 8 256^2 patches, on the card,
through ``fused_conv3x3``.  ``dryrun_multichip(n)`` runs, over an n-device
(dp, sp, mp) mesh (``parallel/mesh.py``), what JAX's does:

1. one mesh train step (``training/train.py::shard_train_step``) against
   the serial step on the same batch;
2. the dp inference step (``parallel/inference.py::build_sharded_step``)
   against the serial step on a non-overlapping 64 px patch grid: the
   oracle model bit for bit, the dense model in bf16 within 5e-3;
3. the sp tile step (``engine/tile_infer.py::build_tile_step_sp``) against
   the one-device step on a 96 + 2 * 16 tile in f32, within 1e-5.

JAX re-runs itself in a subprocess to fake an n-device CPU topology; torch
takes its devices from the argument (``devices=["cpu"] * 8`` fakes eight),
so nothing is re-run.  ``blocks`` cuts the DenseNet's depth for a CPU run.

    python -m digipathai_tpu_torch.dryrun            # entry() on the card
    python -m digipathai_tpu_torch.dryrun multichip 8
"""

from __future__ import annotations

import copy
import sys

import numpy as np
import torch

DENSE_BLOCKS = (6, 12, 24, 16)
# the mesh step against the serial step in bf16: each strip and channel
# slice rounds its own convs (the full-width step on the card: PERF.md)
TRAIN_LOSS_REL = 1e-2
DP_BOUND = 5e-3   # dense bf16, dp against serial (JAX's bound)
SP_BOUND = 1e-5   # dense f32, sp against serial (JAX's bound)


def entry(device="cuda"):
    """(fn, example_args): ``fn(model, x)`` is the DenseNet121-U-Net's
    bf16 forward of ``x`` (8, 256, 256, 3) on ``device``."""
    from .models.registry import build_model

    bundle = build_model("dense", dtype=torch.bfloat16)
    model = bundle.init(256).to(device)

    def fn(model, x):
        with torch.inference_mode():
            return bundle.apply(model, x)

    return fn, (model, torch.zeros((8, 256, 256, 3), device=device))


def _one_hot(rng, n, size, device):
    lab = rng.integers(0, 2, (n, size, size))
    return torch.from_numpy(np.eye(2, dtype=np.float32)[lab]).to(device)


def dryrun_multichip(n_devices: int, devices=None, blocks=DENSE_BLOCKS,
                     log=print) -> None:
    """The three checks above over ``make_mesh(n_devices, devices)``;
    raises ``AssertionError`` where one fails."""
    from .engine.infer import build_step
    from .engine.tile_infer import build_tile_step, build_tile_step_sp
    from .models.registry import build_model
    from .ops.stitch import make_accumulator
    from .parallel import inference as par
    from .parallel.mesh import make_mesh
    from .training import train

    mesh = make_mesh(n_devices, devices)
    dp, sp, mp = (mesh.shape[a] for a in ("dp", "sp", "mp"))
    devs = mesh.flat()
    dev0 = devs[0]
    log(f"mesh: dp={dp} sp={sp} mp={mp} over {n_devices} devices")

    # 1. the flagship model, a small spatial extent (32 * sp divides it)
    bundle = build_model("dense", dtype=torch.bfloat16, blocks=blocks)
    patch, batch = max(64, 32 * sp), 4 * dp
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((batch, patch, patch, 3),
                                    np.float32)).to(dev0)
    y = _one_hot(rng, batch, patch, dev0)
    model = bundle.init(patch).to(dev0)
    twin = copy.deepcopy(model)
    serial = train.TrainState(twin, train.make_optimizer(twin.parameters()))
    ms = train.shard_state(train.TrainState(
        model, train.make_optimizer(model.parameters())), mesh)
    step = train.shard_train_step(mesh)
    try:
        loss = float(step(ms, x, y))
    finally:
        step.close()
    want = float(train.make_train_step()(serial, x, y))
    assert abs(loss - want) <= TRAIN_LOSS_REL * abs(want), (loss, want)
    log(f"dryrun_multichip OK: one sharded train step, loss={loss:.4f} "
        f"(serial {want:.4f})")

    # 2. the dp inference step: each accumulator pixel gets exactly one
    # contribution, so only the models' own rounding can differ
    p_, s_, b_ = 64, 192, 2  # (s_ + p_) / p_ = a 4x4 grid of cells
    n_tot = n_devices * b_
    assert n_tot <= ((s_ + p_) // p_) ** 2, "grid must fit one patch per cell"
    tta = ["DEFAULT", "FLIP_LEFT_RIGHT"]
    side = (s_ + p_) // p_
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                     -1).reshape(-1, 2)
    patches = rng.integers(0, 255, (n_tot, p_, p_, 3)).astype(np.uint8)
    offsets = (cells[:n_tot] * p_).astype(np.int32)
    valid = np.ones((n_tot,), bool)
    valid[-1] = False  # one padding patch: masking must survive sharding

    def dp_vs_serial(name, **kw):
        b = build_model(name, dtype=torch.bfloat16, **kw)
        v = [b.init(p_).to(dev0)]
        acc = build_step([b], tta, p_, device=dev0)(
            v, make_accumulator(s_, p_, planes=2, device=dev0), patches,
            offsets, valid)
        stepd = par.build_sharded_step([b], tta, p_, devs)
        accs = stepd(par.replicas(v, devs),
                     par.make_sharded_accumulator(devs, s_, p_, planes=2),
                     par.shard_batch(devs, patches, offsets, valid))
        return (acc.float().cpu().numpy(),
                par.reduce_accumulator(accs).float().cpu().numpy())

    serial_acc, sharded_acc = dp_vs_serial("oracle")
    np.testing.assert_array_equal(sharded_acc, serial_acc)
    serial_acc, sharded_acc = dp_vs_serial("dense", blocks=blocks)
    np.testing.assert_allclose(sharded_acc, serial_acc, atol=DP_BOUND)
    log(f"dryrun_multichip OK: dp={n_devices} inference supertile step - "
        f"oracle bit-equal, dense within {DP_BOUND} "
        f"(|acc|={float(np.abs(serial_acc).sum()):.3f})")

    # 3. the sp tile step: one supertile over every device
    tile, halo2 = 96, 16  # padded side 128 divides any pow2 device count
    if (tile + 2 * halo2) % n_devices == 0:
        b = build_model("dense", dtype=torch.float32, blocks=blocks)
        v = [b.init(p_).to(dev0)]
        tile_u8 = rng.integers(0, 255, (tile + 2 * halo2,) * 2 + (3,)
                               ).astype(np.uint8)
        m1, _ = build_tile_step([b], tta, tile, halo2,
                                compute_dtype=torch.float32,
                                device=dev0)(v, tile_u8)
        stepsp = build_tile_step_sp([b], tta, tile, halo2, devs,
                                    compute_dtype=torch.float32)
        try:
            msp, _ = stepsp(par.replicas(v, devs), tile_u8)
        finally:
            stepsp.close()
        np.testing.assert_allclose(msp.cpu().numpy(), m1.cpu().numpy(),
                                   atol=SP_BOUND)
        log(f"dryrun_multichip OK: sp={n_devices} tile step matches serial")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry OK:", tuple(out.shape))
