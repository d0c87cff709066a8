"""The port's two slide-level examples on the CPU.

- ``examples/batch_segment_torch.py``: two gloo processes on one localhost
  coordinator split a three-slide directory ``[1, 2]``, as
  ``tests/test_distributed.py`` holds JAX's sweep; each mask is written
  once and equals a serial ``getSegmentation`` of its slide.
- ``examples/run_segmentation_torch.py``: the oracle model on a slide with
  its ``-gt`` pair; the score it prints is what JAX's
  ``examples/run_segmentation.py::evaluate`` gives on the same mask and
  ground truth, and the comparison figure is written.
"""

import importlib.util
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
EXAMPLES = os.path.join(REPO, "examples")


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("DPAI_OFFLINE", "1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batch_segment_two_hosts(tmp_path, monkeypatch):
    """Two gloo processes split three slides [1, 2] and report the total;
    every slide gets its mask once, equal to a serial run's."""
    from digipathai_tpu_torch import Slide, getSegmentation
    from tests.fixtures import make_synthetic_slide

    d = tmp_path / "slides"
    d.mkdir()
    for i in range(3):
        make_synthetic_slide(str(d / f"s{i}.tiff"), 512, 512, seed=40 + i)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2",
               DPAI_OFFLINE="1", DPAI_CACHE=str(tmp_path / "cache"))
    for k in ("DPAI_COORDINATOR", "DPAI_NUM_PROCESSES", "DPAI_PROCESS_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, "batch_segment_torch.py"),
         str(d), "--quick", "--model", "oracle", "--mode", "breast",
         "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        assert "all hosts segmented 3 slides" in out
    host_counts = sorted(
        len(re.findall(r"^\[\d+/\d+\] s\d\.tiff", out, re.M))
        for _, out in outs)
    assert host_counts == [1, 2]
    masks = sorted(p.name for p in d.glob("*-dgai-mask*"))
    assert masks == ["s0-dgai-mask.tiff", "s1-dgai-mask.tiff",
                     "s2-dgai-mask.tiff"]

    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "serial-cache"))
    for i in range(3):
        out = {k: str(tmp_path / f"serial{i}-{k}.tiff")
               for k in ("probs", "mask", "uncertainty")}
        getSegmentation(str(d / f"s{i}.tiff"), quick=True, model="oracle",
                        mode="breast", probs_path=out["probs"],
                        mask_path=out["mask"],
                        uncertainty_path=out["uncertainty"], device="cpu")
        with Slide(out["mask"]) as want, \
                Slide(str(d / f"s{i}-dgai-mask.tiff")) as got:
            np.testing.assert_array_equal(got.read_level(0),
                                          want.read_level(0))


def test_run_segmentation_scores_as_jax(tmp_path, capsys, monkeypatch):
    """The oracle on a slide and its -gt pair: the printed score equals
    JAX's ``evaluate`` on the same mask and ground truth, and the
    figure is written."""
    from digipathai_tpu_torch.io.backend import write_pyramid
    from tests.fixtures import render_he_like

    img, _, lesion = render_he_like(768, 512, seed=3)
    slide = str(tmp_path / "s.tiff")
    write_pyramid(slide, img, compression="deflate")
    write_pyramid(str(tmp_path / "s-gt.tiff"),
                  (lesion * 255).astype(np.uint8), compression="deflate")
    out = tmp_path / "results"
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))
    rc = _example("run_segmentation_torch").main(
        [slide, "--models", "oracle", "--mode", "breast", "--out", str(out),
         "--patch", "128", "--stride", "64", "--batch", "8",
         "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    score = float(re.search(r"^oracle: [\d.]+s, IoU=([\d.]+)$", printed,
                            re.M).group(1))
    mask = str(out / "s-oracle-dgai-mask.tiff")
    want = _example("run_segmentation").evaluate(
        mask, str(tmp_path / "s-gt.tiff"))
    got = _example("run_segmentation_torch").evaluate(
        mask, str(tmp_path / "s-gt.tiff"))
    assert got == want > 0.5
    assert score == round(want, 4)
    assert (out / "s-comparison.png").stat().st_size > 0
