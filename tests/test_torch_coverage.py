"""The port covers the JAX package: every module and every JAX-side script
has its counterpart in the port, or stands in an explicit list of what is
not ported and why.  The tests read files only.
"""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "digipathai_tpu")
PORT_PKG = os.path.join(REPO, "digipathai_tpu_torch")

# JAX modules the port does not need: TPU layout rewrites that compute
# what the canonical form computes (ROADMAP.md, "Not to port")
NOT_TO_PORT = {
    "models/heads.py": "the rank-3 binary head, a TPU layout rewrite",
    "models/s2d_decoder.py": "the space-to-depth decoder, a TPU layout "
                             "rewrite",
    "ops/s2d_input.py": "the space-to-depth input, a TPU layout rewrite",
    "ops/wpack.py": "width-packed convs, a TPU layout rewrite",
}
# the Pallas kernels became hand-written CUDA
PALLAS_TO_CUDA = {
    "ops/pallas/__init__.py": None,
    "ops/pallas/conv_fused.py": "csrc/conv_fused.cu",
    "ops/pallas/stage_fused.py": "csrc/stage_fused.cu",
    "ops/pallas/bilateral.py": "csrc/bilateral.cu",
}

# JAX-side scripts with no ``_torch`` counterpart, and why
SCRIPTS_NOT_PORTED = {
    **{f"tools/{n}.py": "a TPU probe" for n in (
        "conv_fused_probe", "decoder_conv_probe", "dense_layer_probe",
        "encoder_probe", "encoder_probe2", "stem_probe", "stem_probe2",
        "stem_probe3", "stem_probe4", "inception_stem_probe", "stage_probe",
        "stage_fused_probe", "shape_probe", "mxu_probe", "xla_flag_probe",
        "tile_batch_probe", "do_crf_bound_probe")},
    "tools/roofline.py": "holds TPU v5e peaks",
    "tools/flops_probe.py": "holds TPU v5e peaks",
    "tools/dp_scaling_probe.py": "scales over JAX's CPU mesh",
    "bench.py": "the benchmark's: bench_torch.py is a benchmark PR's work",
    # the port's own tool: it imports JAX only to compare with it
    "tools/torch_train_grad_seeds.py": "the port's (compares with JAX)",
}
# JAX-side scripts whose counterpart has another name
SCRIPT_COUNTERPARTS = {"__graft_entry__.py": "digipathai_tpu_torch/dryrun.py"}

_JAX_USE = re.compile(
    r"^\s*(from|import)\s+(digipathai_tpu|jax|flax)(\.|\s|$)"
    r"|[\"']digipathai_tpu\.", re.M)


def _read(rel):
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def _jax_side(rel) -> bool:
    """Whether a script imports the JAX package, jax or flax, or starts a
    module of the JAX package."""
    return bool(_JAX_USE.search(_read(rel)))


def _modules(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _scripts():
    out = [f for f in os.listdir(REPO) if f.endswith(".py")]
    for sub in ("examples", "tools"):
        out += [f"{sub}/{f}" for f in os.listdir(os.path.join(REPO, sub))
                if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("rel", _modules(JAX_PKG))
def test_every_jax_module_has_a_port_counterpart(rel):
    if rel in NOT_TO_PORT:
        assert not os.path.exists(os.path.join(PORT_PKG, rel))
        return
    if rel in PALLAS_TO_CUDA:
        cu = PALLAS_TO_CUDA[rel]
        assert cu is None or os.path.isfile(os.path.join(PORT_PKG, cu)), cu
        return
    assert os.path.isfile(os.path.join(PORT_PKG, rel)), (
        f"digipathai_tpu/{rel} has no counterpart in digipathai_tpu_torch/")


def test_lists_name_existing_files():
    jax_modules = set(_modules(JAX_PKG))
    assert set(NOT_TO_PORT) <= jax_modules
    assert {m for m in jax_modules if m.startswith("ops/pallas/")} == set(
        PALLAS_TO_CUDA)
    scripts = set(_scripts())
    for rel in (*SCRIPTS_NOT_PORTED, *SCRIPT_COUNTERPARTS):
        assert rel in scripts and _jax_side(rel), rel


@pytest.mark.parametrize("rel", _scripts())
def test_every_jax_side_script_has_a_port_counterpart(rel):
    stem = rel[:-len(".py")]
    if stem.endswith("_torch") or rel == "chip_smoke.py" or (
            rel.startswith("tools/torch_")
            and rel not in SCRIPTS_NOT_PORTED):
        # the port's own scripts import nothing of the JAX side
        assert not _jax_side(rel), rel
        return
    if not _jax_side(rel) or rel in SCRIPTS_NOT_PORTED:
        return
    counterpart = SCRIPT_COUNTERPARTS.get(rel, f"{stem}_torch.py")
    assert os.path.isfile(os.path.join(REPO, counterpart)), (
        f"{rel} runs the JAX package and has no counterpart {counterpart}")
    assert not _jax_side(counterpart), counterpart
