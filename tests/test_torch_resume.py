"""Restartable stitching in the port's engine, pinned to the JAX engine's
behaviour (``tests/test_resume.py``): an interrupted run resumes to the
clean result, an in-flight taint discards the state, slides of one name in
two directories keep apart, and a changed config (the stride, or the
``quantized`` knob of a model that runs) starts anew.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("DPAI_OFFLINE", "1")
    monkeypatch.setenv("DPAI_CACHE", str(tmp_path / "cache"))


def _run(path, tmp_path, resume, interrupt_after=None, tag="r", **kw):
    """One port engine run: (mask, or None if interrupted; the progress
    count at the end; the batches this run computed)."""
    from digipathai_tpu_torch import getSegmentation

    calls = {"n": 0, "ran": 0}

    def cb(done, total):
        calls["n"] = done
        calls["ran"] += 1
        if interrupt_after is not None and done >= interrupt_after:
            raise KeyboardInterrupt

    args = dict(patch_size=128, stride_size=64, batch_size=4, quick=True,
                model="oracle", mode="breast", supertile=256, num_workers=2)
    args.update(kw)
    try:
        out = getSegmentation(
            img_path=path, probs_path=str(tmp_path / f"{tag}p.tiff"),
            mask_path=str(tmp_path / f"{tag}m.tiff"),
            uncertainty_path=str(tmp_path / f"{tag}u.tiff"),
            resume=resume, progress_cb=cb, device="cpu", **args)
        return np.asarray(out), calls["n"], calls["ran"]
    except KeyboardInterrupt:
        return None, calls["n"], calls["ran"]


def _slide(tmp_path, name, seed, w=512, h=512):
    from tests.fixtures import make_synthetic_slide

    p = str(tmp_path / name)
    make_synthetic_slide(p, w, h, seed=seed)
    return p


def _state(tmp_path):
    return next((tmp_path / "cache").glob("memmaps/*-stitch.json"))


def test_resume_after_interrupt_matches_clean_run(tmp_path):
    p = _slide(tmp_path, "res-slide.tiff", 31)
    ref, total, _ = _run(p, tmp_path, resume=False, tag="a")
    assert ref is not None and total > 4
    out, *_ = _run(p, tmp_path, resume=False, interrupt_after=total // 2,
                   tag="b")
    assert out is None
    assert json.loads(_state(tmp_path).read_text())["completed"]
    out2, n2, ran = _run(p, tmp_path, resume=True, tag="b")
    # the completed supertiles were skipped
    assert out2 is not None and n2 == total and ran < total
    np.testing.assert_array_equal(out2, ref)


def test_inflight_taint_discards_resume_state(tmp_path):
    """A crash between the inflight mark and the completion mark leaves
    partial, unrepeatable += writes in the maps: the resume starts over and
    still gives the clean result."""
    p = _slide(tmp_path, "taint-slide.tiff", 34)
    ref, total, _ = _run(p, tmp_path, resume=False, tag="t")
    out, *_ = _run(p, tmp_path, resume=False, interrupt_after=total // 2,
                   tag="t")
    assert out is None
    sp = _state(tmp_path)
    state = json.loads(sp.read_text())
    assert state["completed"]
    state["inflight"] = [state["completed"][0]]  # a crash mid-flush
    sp.write_text(json.dumps(state))
    out2, _, ran = _run(p, tmp_path, resume=True, tag="t")
    assert out2 is not None and ran == total  # the tainted state was dropped
    np.testing.assert_array_equal(out2, ref)


def test_same_basename_different_dirs_do_not_clobber(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa = _slide(tmp_path, "a/slide.tiff", 35)
    pb = _slide(tmp_path, "b/slide.tiff", 36)
    _run(pa, tmp_path, resume=False, tag="da")
    _run(pb, tmp_path, resume=False, tag="db")
    states = list((tmp_path / "cache").glob("memmaps/*-stitch.json"))
    assert len(states) == 2  # one state per path despite one file name


def test_config_change_invalidates_state(tmp_path):
    p = _slide(tmp_path, "cfg-slide.tiff", 32)
    _run(p, tmp_path, resume=False, stride_size=128)
    # another stride: the state is invalid, the rerun is full and correct
    out, _, ran = _run(p, tmp_path, resume=True, stride_size=64)
    assert ran > 0 and set(np.unique(out)) <= {0, 255}


def test_quantized_knob_change_invalidates_state(tmp_path):
    """The config key covers the quantization of the models that run: a
    quantized rerun of an exact run starts anew, while a spec that names
    only a model absent from the run keeps the state."""
    p = _slide(tmp_path, "quant-slide.tiff", 38, 256, 192)
    kw = dict(model="dense", patch_size=64, stride_size=64,
              supertile=128, num_workers=1)
    _, total, _ = _run(p, tmp_path, resume=False, **kw)
    assert total > 0
    *_, ran = _run(p, tmp_path, resume=True, quantized="deeplabv3:static",
                   **kw)
    assert ran == 0  # nothing recomputed: deeplabv3 does not run
    *_, ran = _run(p, tmp_path, resume=True, quantized=True, **kw)
    assert ran == total  # every batch recomputed
