"""The port's host surfaces on the CPU: the WSGI entry and its uwsgi
config, the demo-slide example, the HTTP smoke drive, the fuzz soak, the
tile-parity probe and the per-layer activation harness.

Each runs where the JAX counterpart runs, at a small size: the WSGI entry
and the fuzz soak in fresh interpreters that must load no torch (the WSGI
entry) and no JAX module; the smoke drive against a CLI child on the CPU
(and, left on its default ``cuda`` without a card, failing with ``Error``); the
demo slide byte for byte the JAX example's; the activation harness
against JAX's tool on TinyUNet and on its own on the DenseNet.
"""

import importlib.util
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
JAX_SIDE = ("jax", "flax", "digipathai_tpu")


def _load(rel, name=None):
    """A script of the repository as a fresh module, loaded by its path."""
    path = os.path.join(REPO, rel)
    name = name or os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fresh(code, **env):
    """Run ``code`` in a fresh interpreter from the repository root, with
    ``env`` over this environment (None unsets a variable); its last
    stdout line is JSON."""
    env = {**os.environ, **env}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env={k: v for k, v in env.items() if v is not None})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _imported(log_text):
    """Top-level packages named in a ``PYTHONPROFILEIMPORTTIME`` log."""
    names = re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s+(\S+)$",
                       log_text, re.M)
    return {n.split(".")[0] for n in names}, set(names)


@pytest.fixture(scope="module")
def fixtures():
    sys.path.insert(0, TOOLS)
    import torch_fixtures

    return torch_fixtures


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory, fixtures):
    d = tmp_path_factory.mktemp("deploy_slides")
    fixtures.make_synthetic_slide(str(d / "fixture.tiff"), 512, 384, seed=9)
    return d


# --- (a) the WSGI entry and its uwsgi config -------------------------------

WSGI_PROBE = """
import json, sys
from wsgiref.util import setup_testing_defaults
import wsgi_torch
env = {"PATH_INFO": "/", "REQUEST_METHOD": "GET"}
setup_testing_defaults(env)
seen = {}
body = b"".join(wsgi_torch.application(
    env, lambda status, headers, exc=None: seen.setdefault("s", status)))
cfg = wsgi_torch.application.dpai["config"]
print(json.dumps({
    "status": seen["s"], "body": body.decode(), "slide_dir": cfg.slide_dir,
    "viewer_only": cfg.viewer_only,
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "flax", "digipathai_tpu"))}))
"""


@pytest.mark.parametrize("viewer_only", [None, "1", "0", "yes"])
def test_wsgi_entry_serves_without_torch(viewer_only, slide_dir):
    got = _fresh(WSGI_PROBE, DPAI_SLIDE_DIR=str(slide_dir),
                 DPAI_VIEWER_ONLY=viewer_only)
    assert got["loaded"] == []  # uwsgi forks after loading: no CUDA, no JAX
    assert got["status"].startswith("200") and "fixture.tiff" in got["body"]
    assert got["slide_dir"] == str(slide_dir)
    assert got["viewer_only"] is (viewer_only != "0")  # wsgi.py:19


def test_wsgi_entry_and_ini_mirror_jax():
    def config_block(path):
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        return text[text.index("application = "):]

    assert config_block("wsgi_torch.py") == config_block("wsgi.py")
    with open(os.path.join(REPO, "deploy", "digipathai.ini")) as f:
        jax_ini = f.read().splitlines()
    with open(os.path.join(REPO, "deploy", "digipathai_torch.ini")) as f:
        ini = f.read().splitlines()
    assert len(ini) == len(jax_ini)
    diff = [(a, b) for a, b in zip(jax_ini, ini) if a != b]
    assert diff == [("module = wsgi:application",
                     "module = wsgi_torch:application")]
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        scripts = f.read()
    assert ('digipathai-torch = "digipathai_tpu_torch.server.cli:main"'
            in scripts)


# --- (b) the demo slide ------------------------------------------------------

def test_demo_slide_equals_jax_example(tmp_path, monkeypatch):
    from digipathai_tpu.io import backend as jb

    from digipathai_tpu_torch.io import backend as tb

    monkeypatch.setattr(jb, "_FORCED", "0")
    monkeypatch.setattr(tb, "_FORCED", "0")
    args = ["--size", "512", "384", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["make_demo_slide.py",
                                      str(tmp_path / "jax"), *args])
    assert _load("examples/make_demo_slide.py", "jax_demo").main() == 0
    port = _load("examples/make_demo_slide_torch.py")
    assert port.main([str(tmp_path / "port"), *args]) == 0
    for name in ("demo-slide.tiff", "demo-slide-gt.tiff"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert len(a) > 1000 and a == b, name


# --- (c) the HTTP smoke drive ------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    return _load("tools/http_smoke_torch.py")


def test_http_smoke_routes_on_cpu_oracle_child(tmp_path, smoke, fixtures):
    name = "demo.tiff"
    fixtures.make_synthetic_slide(str(tmp_path / name), 512, 512, seed=9)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = str(tmp_path / "server.log")
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1",
               DPAI_CACHE=str(tmp_path / "cache"))
    srv = smoke.start_server(str(tmp_path), port, device="cpu",
                             extra=["--model", "oracle"], env=env,
                             log_path=log_path)
    lines = []
    try:
        smoke.wait_ready(base, srv, timeout=120)
        fails, seconds = smoke.run_checks(base, name, log=lines.append)
    finally:
        smoke.stop_server(srv)
    with open(log_path) as f:
        top, names = _imported(f.read())
    assert fails == [], "\n".join(lines)
    assert len(lines) == 15 and seconds < 120
    # the child ran the port's engine and loaded no JAX module
    assert "digipathai_tpu_torch.engine.segmentation" in names
    assert not top & set(JAX_SIDE), sorted(top & set(JAX_SIDE))


def test_http_smoke_without_cuda_fails_with_error(tmp_path):
    """The CLI child on its default device (``cuda``) on a machine without
    CUDA ends its run in ``Error``, and the smoke exits non-zero: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "http_smoke_torch.py"),
         "--port", str(_free_port())], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPROFILEIMPORTTIME="1",
                 DPAI_CACHE=str(tmp_path / "cache")))
    assert r.returncode == 1, r.stdout[-3000:]
    assert re.search(r"^FAIL segmentation reaches Done \(Error after",
                     r.stdout, re.M), r.stdout[-3000:]
    assert "torch.cuda.is_available() is False" in r.stdout
    top, _ = _imported(r.stderr)  # the tool's own imports
    assert not top & set(JAX_SIDE), sorted(top & set(JAX_SIDE))


# --- (d) the fuzz soak -----------------------------------------------------

FUZZ = """
import json, os, sys
sys.path.insert(0, "tools")
import fuzz_soak_torch as f
f.FINDINGS_PATH = os.path.join({d!r}, "findings.txt")
fx = f._fixtures()
fx.make_synthetic_slide({d!r} + "/s.tiff", width=256, height=192)
fx.make_svs_like_slide({d!r} + "/s.svs", 256, 192)
bad = [f.mutate_and_probe("tiff", {d!r} + "/s.tiff", n_flip=40, n_splat=20,
                          n_trunc=6, seed0=21_000),
       f.mutate_and_probe("svs", {d!r} + "/s.svs", n_flip=40, n_splat=20,
                          n_trunc=6, seed0=22_000)]
print(json.dumps({{"bad": bad, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in
    ("torch", "jax", "flax", "digipathai_tpu"))}}))
"""


def test_fuzz_soak_finds_no_violation(tmp_path):
    got = _fresh(FUZZ.format(d=str(tmp_path)))
    assert got == {"bad": [0, 0], "loaded": []}
    assert not (tmp_path / "findings.txt").exists()


# --- (e) the tile-parity probe ---------------------------------------------

def test_tile_parity_probe_oracle(tmp_path, fixtures, monkeypatch):
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    probe = _load("tools/tile_parity_probe_torch.py")
    slide = str(tmp_path / "parity.tiff")
    fixtures.make_synthetic_slide(slide, 768, 512, seed=11)
    vs = probe.variants(False)
    maps = probe.run("oracle", str(tmp_path), slide, vs, device="cpu")
    assert maps["patch"].shape == maps["tile"].shape == (512, 768)
    line = probe.compare("oracle", maps, vs)
    assert line.startswith("oracle     patch vs tile cmp px=")
    # the oracle is per pixel: stitching gives it the same map both ways
    assert "max|dP|=0.0000" in line and "Dice(mask)=1.00000" in line
    assert [v[0] for v in probe.variants(True)] == ["exact", "int8"]


# --- (f) the activation harness --------------------------------------------

@pytest.fixture(scope="module")
def act():
    return _load("tools/activation_diff_torch.py")


def test_activation_goldens_interchange_with_jax(tmp_path, act):
    """TinyUNet at 32^2: JAX's golden compares in the port's tool with the
    same key set, every layer within 1e-5, and the port's golden in
    JAX's."""
    import jax.numpy as jnp

    from digipathai_tpu.models.registry import build_model
    from tests.test_convert_full import emit_keras_h5

    jax_tool = _load("tools/activation_diff.py", "jax_activation_diff")
    h5 = str(tmp_path / "tiny.h5")
    emit_keras_h5(h5, build_model("tiny", dtype=jnp.float32).init(32, seed=5))
    jax_golden, port_golden = (str(tmp_path / f"{n}.npz")
                               for n in ("jax", "port"))
    common = ["--model", "tiny", "--h5", h5]
    assert jax_tool.main([*common, "--emit-golden", jax_golden,
                          "--patch", "32"]) == 0
    assert act.main([*common, "--golden", jax_golden, "--tol", "1e-5",
                     "--device", "cpu"]) == 0
    assert act.main([*common, "--emit-golden", port_golden, "--patch", "32",
                     "--device", "cpu"]) == 0
    with np.load(jax_golden) as a, np.load(port_golden) as b:
        assert sorted(a.files) == sorted(b.files)
        assert sorted(a.files) == ["Conv_0", "Conv_1", "Conv_2", "Conv_3",
                                   "Conv_4", "Conv_5", "__output__", "input"]
        golden = {k: b[k] for k in b.files}
    rows = jax_tool.activation_diffs("tiny", h5, golden)
    assert len(rows) == 7 and all(ok and d <= 1e-5 for _, d, ok in rows), rows


def test_activation_harness_localizes_a_perturbed_layer(tmp_path, act):
    """The DenseNet at 64^2, torch only (``tests/test_activation_diff.py``
    on the port): a faithful h5 reproduces its own golden, and a perturbed
    h5 is caught at, and not before, the perturbed layer."""
    import shutil

    import h5py

    from digipathai_tpu_torch.models.bridge import torch_to_flax
    from digipathai_tpu_torch.models.convert_h5 import write_keras_h5
    from digipathai_tpu_torch.models.registry import build_model

    h5, golden = str(tmp_path / "dense.h5"), str(tmp_path / "golden.npz")
    write_keras_h5(h5, torch_to_flax(
        build_model("dense", dtype=torch.float32).init(64, seed=5)))
    cpu = ["--device", "cpu"]
    assert act.main(["--model", "dense", "--h5", h5, "--emit-golden", golden,
                     "--patch", "64", *cpu]) == 0
    assert act.main(["--model", "dense", "--h5", h5, "--golden", golden,
                     "--tol", "1e-5", *cpu]) == 0

    bad = str(tmp_path / "bad.h5")
    shutil.copy(h5, bad)
    target = "conv3_block2_1_conv"
    with h5py.File(bad, "r+") as f:
        ds = f[target][f"{target}/kernel:0"]
        ds[...] = np.asarray(ds) + 0.5
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    assert len(g) == 264  # JAX's 263 keys of the DenseNet, and the input
    diffs = {k: v for k, v, ok in act.activation_diffs("dense", bad, g,
                                                       device="cpu")}
    assert diffs["conv1/conv"] == 0.0
    assert diffs["conv3_block1_1_conv"] == 0.0
    assert diffs[target] > 1e-3
    assert diffs["__output__"] > 1e-6
    assert act.main(["--model", "dense", "--h5", bad, "--golden", golden,
                     "--tol", "1e-5", *cpu]) == 1
