"""The slides made from a seed, and the reference's reader of them."""

import hashlib

import numpy as np

from portbench import slides
from portbench.reference import plan, tiff

SPEC = {"layout": "he_like", "width": 512, "height": 384}
SPARSE = {"layout": "sparse", "width": 768, "height": 512, "glass": 243,
          "block": [288, 240], "offset": [48, 48]}


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    for spec in (SPEC, SPARSE):
        a, b, c = (tmp_path / n for n in ("a.tiff", "b.tiff", "c.tiff"))
        slides.write_tiled_pyramid(str(a), slides.render(spec, 2 ** 33 + 5))
        slides.write_tiled_pyramid(str(b), slides.render(spec, 2 ** 33 + 5))
        slides.write_tiled_pyramid(str(c), slides.render(spec, 2 ** 33 + 6))
        assert digest(a) == digest(b) != digest(c)


def test_pyramid_levels_and_reader(tmp_path):
    img = slides.render(SPEC, 1)
    p = tmp_path / "s.tiff"
    dims = slides.write_tiled_pyramid(str(p), img)
    assert dims == [(512, 384), (256, 192)]
    assert [(lv.width, lv.height) for lv in tiff.read_levels(str(p))] == dims
    got = tiff.read_level(str(p), 0)
    assert got.shape == img.shape
    assert np.abs(got.astype(int) - img).mean() < 8  # JPEG at quality 92


def test_reader_agrees_with_the_program(tmp_path):
    from digipathai_tpu_torch.io.slide import Slide

    p = tmp_path / "s.tiff"
    slides.write_tiled_pyramid(str(p), slides.render(SPARSE, 4))
    s = Slide(str(p))
    try:
        ours = tiff.read_level(str(p), 0)
        theirs = np.asarray(s.read_region((0, 0), 0, (768, 512)))[..., :3]
        assert (ours == theirs).all()
    finally:
        s.close()


def test_plan_equals_the_program_plan(tmp_path):
    from digipathai_tpu_torch.engine.planner import plan_patches
    from digipathai_tpu_torch.io.slide import Slide

    for spec in (SPEC, SPARSE):
        p = tmp_path / "s.tiff"
        slides.write_tiled_pyramid(str(p), slides.render(spec, 9))
        groups, dims = plan.plan(str(p), 64, 32, 256)
        s = Slide(str(p))
        theirs = plan_patches(s, 64, 32, 4, 256)
        s.close()
        assert dims == theirs.slide_dims
        assert sorted(groups) == sorted(g.origin for g in theirs.groups)
        for g in theirs.groups:
            assert sorted(map(tuple, g.coords[g.valid].tolist())) == sorted(
                map(tuple, groups[g.origin].tolist()))


def test_pixels_are_the_fixtures():
    """The frozen generator gives the repository fixture's pixels."""
    import importlib.util

    from portbench import run

    spec = importlib.util.spec_from_file_location(
        "repo_fixtures", run.ROOT / "tests" / "fixtures.py")
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    for w, h, seed in ((640, 480, 3), (333, 517, 2 ** 35 + 1)):
        want = fixtures.render_he_like(w, h, seed)[0]
        assert (slides.render_he_like(w, h, seed) == want).all()


def test_half_is_the_rounded_mean():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 50, 3), dtype=np.uint8)
    blk = img[:36, :50].reshape(18, 2, 25, 2, 3).astype(np.float32)
    want = np.round(blk.mean(axis=(1, 3))).astype(np.uint8)
    assert (slides._half(img) == want).all()
