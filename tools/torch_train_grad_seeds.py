#!/usr/bin/env python
"""How far the port's f32 DenseNet train-step gradient is from JAX's f64
step, seed by seed, on the CPU.

For each seed s: a DenseNet121-U-Net with ``blocks=(1, 1, 1, 1)`` at 64^2,
batch 2 (the tree ``randomize(dense_variables(64, s), s)``, the batch from
seed s + 1, as ``tests/test_torch_training.py`` builds them for s = 0),
one port step in f32 against JAX's jitted step in f64.  Prints the
gradient tree's error over its norm, the worst leaf's error over its
floored scale, and the loss's relative error.  These readings set
``F32_GRAD_TOL`` in that test.

Usage: JAX_PLATFORMS=cpu python tools/torch_train_grad_seeds.py [first] [end]
(seeds first..end-1, default 0..7).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(first=0, end=8):
    import jax.numpy as jnp
    import torch

    from tests import test_torch_training as t
    from tests.torch_parity import dense_variables, randomize

    for s in range(first, end):
        v = randomize(dense_variables(64, s, **t.DENSE), s)
        x, y = t._batch(2, 64, s + 1)
        want = t._jax_steps("dense", v, x, y, jnp.float64, x64=True, steps=1,
                            **t.DENSE)[0]
        got = t._port_step("dense", v, x, y, torch.float32, **t.DENSE)
        errs = t._grad_errors(want[1], got[1])
        worst = max(errs, key=errs.get)
        print(f"seed {s}: tree {t._tree_error(want[1], got[1]):.3e} of its "
              f"norm; worst leaf {worst} {errs[worst]:.3e} of its scale; "
              f"loss {abs(got[0] - want[0]) / abs(want[0]):.2e} relative",
              flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
