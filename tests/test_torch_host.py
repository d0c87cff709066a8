"""The port's copied host code (slide readers, pyramid writer, DeepZoom
server) against the JAX package's, on the same fixture files.

The port keeps its own copy of every module it needs; these tests hold the
copies to the originals byte for byte.  Each check runs twice, with both
sides pinned to the same TIFF backend: the pure Python one, and the native
libtiff one (the port's copy of ``dpai_tiff.cpp``, built on first use,
against the JAX package's library), which skips where either library cannot
be built or loaded.  The numpy-only modules (``ops/roi.py``,
``utils/metrics.py``, ``utils/viz.py``) are held to the originals byte for
byte, and the port's two slide-level examples are run in an interpreter
that must load no JAX module.
"""

from wsgiref.util import setup_testing_defaults

import numpy as np
import pytest

import tests.fixtures as fx

MAKERS = {
    "synthetic": ("s.tiff", lambda p: fx.make_synthetic_slide(p, 512, 384,
                                                              seed=1)),
    "svs": ("s.svs", lambda p: fx.make_svs_like_slide(p, 512, 384, seed=2)),
    "scn": ("s.scn", lambda p: fx.make_scn_slide(p, 512, 384, seed=3)),
    "philips": ("s.tiff", lambda p: fx.make_philips_slide(p, 512, 384,
                                                          seed=4)),
    "ventana": ("s.bif", lambda p: fx.make_ventana_slide(p, 512, 384, seed=5)),
    "trestle": ("s.tif", lambda p: fx.make_trestle_slide(p, ncols=4, nrows=3,
                                                         seed=6)),
    "vms": ("s.vms", lambda p: fx.make_vms_slide(p, 512, 256, seed=7)),
    "vmu": ("s.vmu", lambda p: fx.make_vmu_slide(p, 512, 256, seed=8)),
    "ndpi": ("s.ndpi", lambda p: fx.make_ndpi_slide(p, 512, 384, seed=9)),
    "mirax": ("s.mrxs", lambda p: fx.make_mirax_slide(p, seed=10, nx=4,
                                                      ny=3)),
    "sakura": ("s.svslide", lambda p: fx.make_sakura_slide(p, seed=11)),
}


def _pin(monkeypatch, forced):
    """Pin both packages to one TIFF backend (``DPAI_NATIVE`` 0 or 1)."""
    from digipathai_tpu.io import backend as jb
    from digipathai_tpu_torch.io import backend as tb

    monkeypatch.setattr(jb, "_FORCED", forced)
    monkeypatch.setattr(tb, "_FORCED", forced)


@pytest.fixture()
def python_backend(monkeypatch):
    _pin(monkeypatch, "0")


@pytest.fixture()
def native_backend(monkeypatch):
    from digipathai_tpu.io import native as jn
    from digipathai_tpu_torch.io import native as tn

    if not (jn.available() and tn.available()):
        pytest.skip("the native libtiff backend does not build or load here "
                    "(needs libtiff's headers and a C++ compiler)")
    _pin(monkeypatch, "1")


def _get(app, path):
    env = {"PATH_INFO": path, "REQUEST_METHOD": "GET"}
    setup_testing_defaults(env)
    seen = {}

    def start(status, headers, exc_info=None):
        seen["status"] = status

    body = b"".join(app(env, start))
    return seen["status"], body


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_copied_host_code_matches_jax(maker, tmp_path, python_backend):
    """Equal level dimensions and read_region bytes through both Slides, and
    equal .dzi and DeepZoom tile bytes from both servers."""
    _check_host_parity(maker, tmp_path)


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_copied_native_host_code_matches_jax(maker, tmp_path, native_backend):
    """The same through both native libtiff libraries."""
    _check_host_parity(maker, tmp_path)


def _check_host_parity(maker, tmp_path):
    from digipathai_tpu.io.deepzoom import DeepZoomGenerator
    from digipathai_tpu.io.slide import Slide as JSlide
    from digipathai_tpu.server.app import ServerConfig as JConfig
    from digipathai_tpu.server.app import create_app as j_app
    from digipathai_tpu_torch.io.slide import Slide as TSlide
    from digipathai_tpu_torch.server import ServerConfig, create_app

    name, make = MAKERS[maker]
    path = tmp_path / name
    make(str(path))
    with JSlide(str(path)) as js, TSlide(str(path)) as ts:
        assert ts.level_dimensions == js.level_dimensions
        assert ts.level_count == js.level_count > 0
        w, h = js.dimensions
        box = ((w // 4, h // 5), 0, (max(1, w // 2), max(1, h // 2)))
        a, b = js.read_region(*box), ts.read_region(*box)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
        last = js.level_count - 1
        np.testing.assert_array_equal(ts.read_level(last), js.read_level(last))

        top = DeepZoomGenerator(js).level_count - 1
    japp = j_app(JConfig(slide_dir=str(tmp_path)))
    tapp = create_app(ServerConfig(slide_dir=str(tmp_path)))
    for route in (f"/{name}.dzi", f"/{name}_files/{top - 1}/0_0.jpeg",
                  f"/{name}_files/{top}/0_0.png"):
        want = _get(japp, route)
        assert want[0].startswith("200"), (route, want[0])
        assert _get(tapp, route) == want, route


def test_write_pyramid_identical(tmp_path, python_backend):
    """write_pyramid of the same array writes the same bytes."""
    _check_write_pyramid(tmp_path)


def test_native_write_pyramid_identical(tmp_path, native_backend):
    """The same through both native libtiff writers."""
    _check_write_pyramid(tmp_path)


def _check_write_pyramid(tmp_path):
    from digipathai_tpu.io.backend import write_pyramid as j_write
    from digipathai_tpu_torch.io.backend import write_pyramid as t_write

    img, _, _ = fx.render_he_like(700, 500, seed=12)
    for comp in ("jpeg", "deflate"):
        a, b = tmp_path / f"j-{comp}.tiff", tmp_path / f"t-{comp}.tiff"
        j_write(str(a), img, compression=comp, quality=90, mpp=0.5)
        t_write(str(b), img, compression=comp, quality=90, mpp=0.5)
        assert b.read_bytes() == a.read_bytes(), comp


@pytest.mark.parametrize("module", ["ops/roi.py", "utils/metrics.py",
                                    "utils/viz.py"])
def test_numpy_modules_are_byte_identical_copies(module):
    """The numpy-only modules the port copied (cv2 and matplotlib imported
    inside their functions) are the originals byte for byte."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    want = (repo / "digipathai_tpu" / module).read_bytes()
    assert (repo / "digipathai_tpu_torch" / module).read_bytes() == want


def test_copied_metrics_and_roi_agree(tmp_path):
    """The copies compute what the originals do on the same masks."""
    from digipathai_tpu.ops import roi as jroi
    from digipathai_tpu.utils import metrics as jm
    from digipathai_tpu_torch.ops import roi as troi
    from digipathai_tpu_torch.utils import metrics as tm
    from digipathai_tpu_torch.utils import viz

    rng = np.random.default_rng(4)
    a = rng.random((64, 48)) > 0.6
    b = rng.random((64, 48)) > 0.5
    assert tm.dice(a, b) == jm.dice(a, b)
    assert tm.jaccard(a, b) == jm.jaccard(a, b)
    m = np.zeros((64, 64), np.uint8)
    m[5:20, 8:30] = 1
    m[40:60, 35:50] = 1
    assert troi.get_bboxes(m) == jroi.get_bboxes(m)
    np.testing.assert_array_equal(troi.get_all_bbox_masks(m, 2),
                                  jroi.get_all_bbox_masks(m, 2))
    png = tmp_path / "v.png"
    assert viz.imsave(str(png), m * 255, viz.overlay_mask(
        np.full((64, 64, 3), 200, np.uint8), m)) == str(png)
    assert png.stat().st_size > 0


def test_examples_stand_alone(tmp_path):
    """Both slide-level examples of the port run on the CPU in a fresh
    interpreter and load no jax, flax or digipathai_tpu module."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    d = tmp_path / "slides"
    d.mkdir()
    fx.make_synthetic_slide(str(d / "s.tiff"), 384, 256, seed=9)
    code = f"""
import importlib.util, sys
def run(name, argv):
    spec = importlib.util.spec_from_file_location(
        name, {str(repo / "examples")!r} + "/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv) == 0
run("batch_segment_torch", [{str(d)!r}, "--quick", "--model", "oracle",
                            "--device", "cpu"])
run("run_segmentation_torch", [{str(d / "s.tiff")!r}, "--models", "oracle",
                               "--out", {str(tmp_path / "out")!r},
                               "--patch", "128", "--stride", "128",
                               "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "digipathai_tpu"))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(repo), DPAI_OFFLINE="1",
               DPAI_CACHE=str(tmp_path / "cache"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "all hosts segmented 1 slides" in r.stdout
