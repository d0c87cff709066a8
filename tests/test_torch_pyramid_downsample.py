"""The port's pyramid writer builds each coarser level with an exact integer
2x2 mean for unsigned integer maps (``io/tiff_py.py::_box2_int``) and in
float32 for every other dtype.  These tests hold both paths to the float
formula the writer used before, copied below as the oracle, byte for byte,
and the written pyramids to the JAX package's writer.  Every case runs on
the pure-Python TIFF backend."""

import numpy as np
import pytest

from digipathai_tpu_torch.io import tiff_py

#: (dtype, channels) of the levels the writer builds
KINDS = [(np.uint8, 1), (np.uint8, 3), (np.uint16, 1), (np.float32, 1)]
#: (width, height): odd and even, below and above one tile
SIZES = [(700, 501), (513, 257), (256, 256)]
VALUES = ("random", "remainders", "zeros", "max")


@pytest.fixture(autouse=True)
def python_backend(monkeypatch):
    from digipathai_tpu.io import backend as jb
    from digipathai_tpu_torch.io import backend as tb

    monkeypatch.setattr(jb, "_FORCED", "0")
    monkeypatch.setattr(tb, "_FORCED", "0")


def float_downsample(source, w, h, channels, dtype):
    """The 2x2 mean as the writer computed it for every dtype: float32
    means of the reshaped block, rounded for integers."""
    nw, nh = max(1, w // 2), max(1, h // 2)
    block = np.asarray(source[0:2 * nh, 0:2 * nw])
    if block.ndim == 2:
        block = block[:, :, None]
    ds = block.reshape(nh, 2, nw, 2, channels).astype(np.float32).mean(
        axis=(1, 3))
    if np.issubdtype(dtype, np.integer):
        ds = np.round(ds)
    ds = ds.astype(dtype)
    return ds if channels > 1 else ds[:, :, 0]


def make_map(values, w, h, channels, dtype, seed=3):
    rng = np.random.default_rng(seed)
    shape = (h, w, channels) if channels > 1 else (h, w)
    integer = np.issubdtype(dtype, np.integer)
    top = np.iinfo(dtype).max if integer else 1.0
    if values == "zeros":
        return np.zeros(shape, dtype)
    if values == "max":
        return np.full(shape, top, dtype)
    if values == "random":
        if integer:
            return rng.integers(0, top, shape, endpoint=True).astype(dtype)
        return rng.random(shape, np.float32)
    # each 2x2 cell holds a random q four times, one of them raised by
    # r in 0-3: its sum 4q + r takes every remainder, over even and odd
    # quotients up to the top of the dtype (of uint8 for float32)
    top = top if integer else 255
    cells = ((h + 1) // 2, (w + 1) // 2) + shape[2:]
    q = rng.integers(0, top - 3, cells, endpoint=True)
    out = np.repeat(np.repeat(q, 2, axis=0), 2, axis=1)[:h, :w]
    out[0::2, 0::2] += rng.integers(0, 3, cells, endpoint=True)
    return out.astype(dtype)


@pytest.mark.parametrize("branch", ["ram", "scratch"])
@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS, ids=[
    f"{np.dtype(d).name}-{c}ch" for d, c in KINDS])
def test_downsample_matches_float_formula(kind, size, values, branch,
                                          tmp_path, monkeypatch):
    """``_downsample_source`` gives the oracle's bytes; ``scratch`` builds
    the level in a scratch memmap, 64 output rows at a time."""
    dtype, channels = kind
    w, h = size
    if branch == "scratch":
        monkeypatch.setattr(tiff_py, "_DOWNSAMPLE_IN_RAM_BYTES", 0)
        monkeypatch.setattr(tiff_py, "_DOWNSAMPLE_ROWS", 64)
    src = make_map(values, w, h, channels, dtype)
    wr = tiff_py.PyramidalTiffWriter(tmp_path / "p.tiff", w, h,
                                     channels=channels, dtype=dtype,
                                     scratch_dir=str(tmp_path))
    wr._scratch_files = []
    got, nw, nh = wr._downsample_source(src, w, h)
    want = float_downsample(src, w, h, channels, dtype)
    assert (nw, nh) == (w // 2, h // 2)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert isinstance(got, np.memmap) == (branch == "scratch")
    assert len(wr._scratch_files) == (branch == "scratch")
    del got
    wr.finish()
    assert not any(p.name.startswith("dpai_pyr_") for p in tmp_path.iterdir())


@pytest.mark.parametrize("channels", [1, 3])
def test_pyramid_file_matches_jax_writer(channels, tmp_path):
    """A 1100x700 uint8 map (blocky tissue over glass, as the engine's maps
    are) as JPEG q90: the port's file is JAX's, byte for byte."""
    from digipathai_tpu.io import tiff_py as jax_tiff_py

    rng = np.random.default_rng(11)
    shape = (700, 1100, channels) if channels > 1 else (700, 1100)
    img = np.zeros(shape, np.uint8)
    tissue = img[96:611, 130:917]
    tissue[:] = rng.integers(0, 255, tissue.shape, endpoint=True)
    img[300:420, 500:700] = 255
    a, b = tmp_path / "jax.tiff", tmp_path / "port.tiff"
    jax_tiff_py.write_pyramidal_tiff(str(a), img, compression="jpeg",
                                     quality=90)
    tiff_py.write_pyramidal_tiff(str(b), img, compression="jpeg", quality=90)
    assert a.read_bytes() == b.read_bytes()
    with tiff_py.TiffReader(str(b)) as r:
        assert [(p.width, p.height) for p in r.pages] == [
            (1100, 700), (550, 350), (275, 175), (137, 87)]


@pytest.mark.parametrize("dtype,integer", [(np.uint8, True),
                                           (np.float32, False)])
def test_writer_times_and_counts_each_level(dtype, integer, tmp_path):
    """With a timer, each level's downsample is a span inside the caller's
    and is counted on the path that built it."""
    from digipathai_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    src = make_map("random", 1100, 700, 1, dtype)
    with timer.stage("write.pyramid"):
        with tiff_py.PyramidalTiffWriter(
                tmp_path / "p.tiff", 1100, 700, dtype=dtype,
                compression="deflate", timer=timer) as wr:
            wr.write_base(src)
    spans = [s for s in timer.spans if s.name == "write.pyramid.downsample"]
    assert len(spans) == 3
    assert {timer.spans[s.parent].name for s in spans} == {"write.pyramid"}
    assert timer.counters == {"downsample_int_levels": 3 * integer,
                              "downsample_float_levels": 3 * (not integer)}
