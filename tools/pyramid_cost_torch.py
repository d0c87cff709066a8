#!/usr/bin/env python3
"""Where one 8-bit JPEG pyramid's time goes in the port's pure-Python writer.

    python3 tools/pyramid_cost_torch.py [--repeats 3] [--dir DIR]

Writes two 6144x4096 uint8 memmaps shaped like the benchmark cells' maps
(``sparse``: glass zeros with one 2304x1920 tissue block at (384, 384);
``resection``: blocky tissue over about 37% of the slide), then for each
writes its pyramid (JPEG q90, 256² tiles) through
``io/tiff_py.py::PyramidalTiffWriter`` with a ``StageTimer``, and times
the float32 2x2 mean the writer used before, copied below, over the same
levels.  Prints one JSON line per map, the best of ``--repeats``:
``pyramid_s`` (the whole write), ``downsample_s`` (the writer's
``write.pyramid.downsample`` spans), ``emit_s`` (the rest: the tiles'
encodes and writes), ``float_downsample_s`` and ``level1_s`` /
``float_level1_s`` (level 0 to 1 alone), and whether every level the two
paths built is equal.  Host CPU seconds: the card is not used.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

W, H = 6144, 4096


def float_downsample(source, w, h):
    """The writer's float32 2x2 mean of a one-channel uint8 map."""
    nw, nh = max(1, w // 2), max(1, h // 2)
    dst = np.zeros((nh, nw), np.uint8)
    for y in range(0, nh, 4096):
        bh = min(4096, nh - y)
        block = np.asarray(source[2 * y:2 * (y + bh), 0:2 * nw])[:, :, None]
        ds = block.reshape(bh, 2, nw, 2, 1).astype(np.float32).mean(
            axis=(1, 3))
        dst[y:y + bh] = np.round(ds).astype(np.uint8)[:, :, 0]
    return dst, nw, nh


def make_map(kind: str, seed: int = 0) -> np.ndarray:
    """A probability-like map: a field smooth over 32-pixel cells with some
    noise, over the tissue; 0 on glass."""
    rng = np.random.default_rng(seed)
    field = np.repeat(np.repeat(
        rng.integers(0, 255, (H // 32, W // 32), np.uint8), 32, 0), 32, 1)
    noise = rng.integers(0, 8, (H, W), np.uint8)
    img = np.zeros((H, W), np.uint8)
    if kind == "sparse":
        tissue = np.zeros((H, W), bool)
        tissue[384:384 + 1920, 384:384 + 2304] = True
    else:
        cells = np.zeros((H // 256) * (W // 256), bool)
        cells[rng.permutation(cells.size)[:round(0.37 * cells.size)]] = True
        tissue = np.repeat(np.repeat(
            cells.reshape(H // 256, W // 256), 256, 0), 256, 1)
    img[tissue] = np.minimum(field[tissue], 247) + noise[tissue]
    return img


def time_map(mm, out: Path, repeats: int) -> dict:
    from digipathai_tpu_torch.io.tiff_py import PyramidalTiffWriter
    from digipathai_tpu_torch.utils.profiling import StageTimer

    best = {}

    def keep(name, v):
        best[name] = min(best.get(name, v), v)

    for _ in range(repeats):
        timer = StageTimer()
        t0 = time.perf_counter()
        with PyramidalTiffWriter(str(out), W, H, compression="jpeg",
                                 quality=90, scratch_dir=str(out.parent),
                                 timer=timer) as wr:
            wr.write_base(mm)
        total = time.perf_counter() - t0
        spans = [s.end - s.start for s in timer.spans]
        keep("pyramid_s", total)
        keep("downsample_s", sum(spans))
        keep("emit_s", total - sum(spans))
        keep("level1_s", spans[0])

        levels_int, levels_float = [], []
        cur, w, h = mm, W, H
        t0 = time.perf_counter()
        while max(w, h) > 256:
            t1 = time.perf_counter()
            cur, w, h = float_downsample(cur, w, h)
            if not levels_float:
                keep("float_level1_s", time.perf_counter() - t1)
            levels_float.append(cur)
        keep("float_downsample_s", time.perf_counter() - t0)
        wr = PyramidalTiffWriter(str(out), W, H)
        wr._scratch_files = []
        cur, w, h = mm, W, H
        while max(w, h) > 256:
            cur, w, h = wr._downsample_source(cur, w, h)
            levels_int.append(cur)
        wr.finish()
    best["levels"] = len(levels_int)
    best["equal"] = all(np.array_equal(a, b)
                        for a, b in zip(levels_int, levels_float))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dir", default=None,
                    help="where the memmaps and pyramids go (a new "
                         "temporary directory by default)")
    args = ap.parse_args(argv)

    work = Path(args.dir or tempfile.mkdtemp(prefix="pyramid_cost_"))
    work.mkdir(parents=True, exist_ok=True)
    for kind in ("sparse", "resection"):
        path = work / f"{kind}-u8.dat"
        mm = np.memmap(path, np.uint8, "w+", shape=(H, W))
        mm[:] = make_map(kind)
        mm.flush()
        row = {"map": kind, "shape": [H, W], "cpus": os.cpu_count(),
               "tissue_share": round(float((mm > 0).mean()), 4)}
        row.update(time_map(mm, work / f"{kind}.tiff", args.repeats))
        print(json.dumps(row), flush=True)
        del mm
        path.unlink()
        (work / f"{kind}.tiff").unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
