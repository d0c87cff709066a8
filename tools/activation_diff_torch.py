#!/usr/bin/env python
"""Per-layer activation-diff harness on the PyTorch port: a model of
``digipathai_tpu_torch`` (weights from a Keras .h5) against golden
per-layer activations.

The counterpart of ``tools/activation_diff.py``, with the same CLI, plus
``--device`` (default ``cuda``), and the same golden format, so a golden
emitted by either tool compares in the other.  Once the reference's
trained checkpoints are reachable, parity must be checked layer by layer:
this harness takes any Keras ``save_weights`` .h5 and a golden ``.npz``
and reports the max-abs diff per layer, so a conversion or architecture
mismatch localizes to the first diverging layer.

Golden .npz format
------------------
- ``input``: (N, H, W, 3) float32, the normalized input;
- one array per layer, under the flax submodule path with ``__`` turned
  back into ``/`` (the Keras layer name, e.g. ``conv1/conv`` or
  ``aspp0_BN``): that layer's output (N, H, W, C) before any relu;
- ``__output__``: the model's output (N, H, W, classes).

Weights go through ``models/convert_h5.py::keras_h5_to_flax`` into the
seeded module's tree, then ``models/bridge.py::flax_to_torch``.  The
forward is f32 (TF32 off on the card).

Capture: the canonical path
---------------------------
As JAX turns its chunked encoder off, the port runs the canonical forward
of each model, where every layer is computed on its own and no kernel
runs: the DenseNet's, Inception's and TinyUNet's train path (each dense
layer and each Inception branch conv unfused, each decoder block
``F.conv2d`` + BatchNorm + relu) with every BatchNorm on its running
statistics, and DeepLab's inference forward as it is (it is canonical
already; its train path draws dropout).

- **BatchNorm** outputs come from forward hooks on each ``BatchNorm``
  module.  Where the model asks the module for ``relu=True``, a pre-hook
  asks for the BatchNorm alone and the hook records it, then applies the
  relu (the same values: relu commutes with the one rounding).
- **Convs** do not line up with a module call: the port's ``Conv`` holds
  parameters and is never called.  Every conv of the canonical path ends
  in ``parallel.channels.gather(y, kernel)``, so a wrapper around that
  function records ``y`` under the name of the ``Conv`` that owns
  ``kernel`` (bias included, as flax's ``nn.Conv`` returns it).
- **DeepLab's ``Dropout_0``** has no port module (the port applies its
  dropout as a function, in train mode only).  At inference flax's
  ``nn.Dropout`` returns its input, so ``Dropout_0`` is recorded as
  ``concat_projection_BN``'s output after its relu.
- **Inception's packed heads.** JAX's inference forward runs the branch
  convs of mixed_5b, block35, block17, block8 and mixed_7a through
  parameter containers (``packed_heads``), whose outputs flax's capture
  skips, so JAX's goldens have no key for them.  The port captures them
  (its canonical path runs them unpacked) and compares them where a golden
  has them; ``--emit-golden`` leaves them out, so that JAX's tool can
  compare the port's goldens.

Every other flax key has its port module, one to one.  A golden key the
capture lacks is reported as a failing row, never dropped.

Usage::

    python tools/activation_diff_torch.py --model dense --h5 ckpt.h5 \\
        --golden golden.npz [--tol 1e-4] [--device cpu]
    python tools/activation_diff_torch.py --model dense --h5 ckpt.h5 \\
        --emit-golden golden.npz [--patch 64] [--seed 0] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# flax's Dropout at inference is the identity on concat_projection's relu
AFTER_RELU = {"concat_projection_BN": "Dropout_0"}


def _key(name: str) -> str:
    return name.replace("__", "/")


def packed_layers(module) -> set:
    """Keys of the layers JAX's inference forward runs through parameter
    containers (Inception's packed branch heads): absent from JAX's
    goldens."""
    from digipathai_tpu_torch.models.inception_unet import (
        InceptionResNetV2UNet)

    if not isinstance(module, InceptionResNetV2UNet):
        return set()
    groups = [module.mixed_5b, module.mixed_7a]
    groups += [blk[:-1] for blk in (*module.block35, *module.block17,
                                    *module.block8)]
    return {_key(n) for branches in groups for branch in branches
            for p in branch for n in (p.conv, p.bn)}


@contextlib.contextmanager
def canonical(module):
    """``module`` on its canonical path: the train path with every
    BatchNorm on its running statistics (DeepLab: inference as it is)."""
    from digipathai_tpu_torch.models.deeplabv3 import DeepLabV3Plus
    from digipathai_tpu_torch.models.unet_decoder import BatchNorm

    was = module.training
    if not isinstance(module, DeepLabV3Plus):
        module.train()
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.eval()
    try:
        yield module
    finally:
        module.train(was)


@contextlib.contextmanager
def exact_f32(device):
    """TF32 off for convs and matmuls on a CUDA device."""
    import torch

    if torch.device(device).type != "cuda":
        yield
        return
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def load_model(model_name: str, h5_path: str, patch: int, device="cuda",
               dtype=None):
    """The registry's model, seeded, with every weight the h5 names."""
    import torch

    from digipathai_tpu_torch.models.bridge import (flax_to_torch,
                                                    torch_to_flax)
    from digipathai_tpu_torch.models.convert_h5 import keras_h5_to_flax
    from digipathai_tpu_torch.models.registry import build_model

    module = build_model(model_name, dtype=dtype or torch.float32).init(patch)
    variables = keras_h5_to_flax(h5_path, torch_to_flax(module))
    return flax_to_torch(variables, module).to(device)


def capture(module, x, device="cuda"):
    """Run ``module`` on its canonical path on ``device``, capturing every
    layer's output.

    Returns ({layer key: np.ndarray f32}, with the model output under
    ``__output__``; the keys JAX's goldens lack, ``packed_layers``).
    """
    from unittest import mock

    import numpy as np
    import torch

    from digipathai_tpu_torch.models.unet_decoder import BatchNorm, Conv
    from digipathai_tpu_torch.parallel import channels

    module = module.to(device)
    convs = {id(m.kernel): _key(n) for n, m in module.named_modules()
             if isinstance(m, Conv)}
    bns = {m: n for n, m in module.named_modules() if isinstance(m, BatchNorm)}
    acts, relu = {}, {}

    def record(key, y):
        # flax keeps a module's first call; every layer here runs once
        acts.setdefault(key, y.detach().to("cpu", torch.float32).numpy())

    gather = channels.gather

    def gather_and_record(y, leaf):
        y = gather(y, leaf)
        if id(leaf) in convs:
            record(convs[id(leaf)], y)
        return y

    def before(mod, args, kwargs):
        relu[mod] = kwargs.pop("relu", args[1] if len(args) > 1 else False)
        return args[:1], dict(kwargs, relu=False)

    def after(mod, args, kwargs, out):
        name = bns[mod]
        record(_key(name), out)
        if relu.pop(mod):
            out = torch.relu(out)
        if name in AFTER_RELU:
            record(AFTER_RELU[name], out)
        return out

    hooks = []
    for m in bns:
        hooks.append(m.register_forward_pre_hook(before, with_kwargs=True))
        hooks.append(m.register_forward_hook(after, with_kwargs=True))
    try:
        with canonical(module), exact_f32(device), torch.no_grad(), \
                mock.patch.object(channels, "gather", gather_and_record):
            out = module(torch.from_numpy(np.asarray(x, np.float32)).to(
                device))
    finally:
        for h in hooks:
            h.remove()
    acts["__output__"] = out.to("cpu", torch.float32).numpy()
    return acts, packed_layers(module)


def _capture_activations(model_name: str, h5_path: str, x, device="cuda",
                         dtype=None):
    """``capture`` of the registry's model with the h5's weights."""
    return capture(load_model(model_name, h5_path, x.shape[1], device,
                              dtype), x, device)


def diff_rows(acts: dict, golden: dict) -> list:
    """[(layer, max_abs_diff, golden_shape_ok)] in golden-file order for
    every golden key that names a layer (skips 'input'); a key ``acts``
    lacks gives nan, a shape mismatch inf."""
    import numpy as np

    rows = []
    for k in golden:
        if k == "input":
            continue
        g = np.asarray(golden[k], dtype=np.float32)
        if k not in acts:
            rows.append((k, float("nan"), False))
            continue
        a = acts[k]
        if a.shape != g.shape:
            rows.append((k, float("inf"), False))
            continue
        rows.append((k, float(np.abs(a - g).max()), True))
    return rows


def activation_diffs(model_name: str, h5_path: str, golden: dict,
                     dtype=None, device="cuda") -> list:
    """Compare the port's activations against a golden dict (see module
    docstring): ``diff_rows`` of the capture."""
    acts, _ = _capture_activations(model_name, h5_path, golden["input"],
                                   device=device, dtype=dtype)
    return diff_rows(acts, golden)


def emit_golden(model_name: str, h5_path: str, path: str, patch: int = 64,
                seed: int = 0, device="cuda") -> int:
    """Write the port's own activations as a golden .npz (JAX's key set);
    returns the number of layers written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    # normalized-input distribution (reference mean/std normalization)
    x = rng.normal(0.0, 1.0, (1, patch, patch, 3)).astype(np.float32)
    acts, packed = _capture_activations(model_name, h5_path, x,
                                        device=device)
    acts = {k: v for k, v in acts.items() if k not in packed}
    np.savez_compressed(path, input=x, **acts)
    return len(acts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True,
                    help="registry name: dense/inception/deeplabv3/...")
    ap.add_argument("--h5", required=True, help="Keras save_weights .h5")
    ap.add_argument("--golden", help="golden .npz to compare against")
    ap.add_argument("--emit-golden", metavar="PATH",
                    help="write this model's own activations as a golden .npz")
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on [cuda]")
    args = ap.parse_args(argv)

    import numpy as np

    if args.emit_golden:
        n = emit_golden(args.model, args.h5, args.emit_golden, args.patch,
                        args.seed, args.device)
        print(f"wrote {n} layer activations -> {args.emit_golden}")
        return 0

    if not args.golden:
        ap.error("need --golden or --emit-golden")
    with np.load(args.golden) as z:
        golden = {k: z[k] for k in z.files}
    rows = activation_diffs(args.model, args.h5, golden, device=args.device)
    worst, worst_layer, first_bad = 0.0, None, None
    for layer, diff, ok in rows:
        status = "OK" if ok and diff <= args.tol else "FAIL"
        if status == "FAIL" and first_bad is None:
            first_bad = layer
        d = diff if diff == diff else float("inf")
        if worst_layer is None or d > worst:
            worst, worst_layer = d, layer
        print(f"{status:4s} {layer:50s} max|Δ| = {diff:.3e}")
    print(f"worst max|Δ| = {worst:.3e} over {len(rows)} layers (tol "
          f"{args.tol}) at {worst_layer}")
    if first_bad is not None:
        print(f"first diverging layer: {first_bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
