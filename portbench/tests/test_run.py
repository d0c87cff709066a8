"""A whole run of the tiny test cell on the CPU: the program against the
reference through the benchmark's own comparison, the result's keys, and
the runs that have to come out not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import judge, run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def tiny(tiny_bench, tmp_path, cell="tiny", **kw):
    torch.set_num_threads(4)
    return run.run(cell, 2 ** 40 + 3, 0.5, False, "cpu",
                   bench_path=tiny_bench, workdir=tmp_path / "w", **kw)


def test_tiny_run_is_correct(tiny_bench, tmp_path):
    r = tiny(tiny_bench, tmp_path)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"patches_per_s", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = run.load_cell("tiny", tiny_bench)[3]["limits"]
    assert set(r["checks"]) == set(limits) <= set(judge.NAMES)
    json.dumps(r, allow_nan=False)
    assert not (tmp_path / "w").exists()  # the run cleans up


def broken(monkeypatch, fault):
    """Break the program's patch step underneath the harness."""
    from digipathai_tpu_torch.engine import segmentation

    real = segmentation.build_step
    if fault == "half_batch":
        # the second half of every batch left out, of the sums and of the
        # counts alike: the mean is taken over the rest
        real_counts = segmentation.add_counts_host

        def add_counts_host(count_map, coords, valid, patch):
            keep = np.asarray(valid, bool).copy()
            batch = json.loads((run.ROOT / "portbench" / "tests" / "data" /
                                "tiny-dense.json").read_text())["batch_size"]
            keep[(np.arange(len(keep)) % batch) >= batch // 2] = False
            return real_counts(count_map, coords, keep, patch)

        monkeypatch.setattr(segmentation, "add_counts_host", add_counts_host)

    def build_step(*a, **k):
        step = real(*a, **k)

        def wrapped(variables_list, acc, patches_u8, offsets, valid):
            if fault == "unchanged":
                return acc
            if fault == "half_batch":
                valid = np.asarray(valid).copy()
                valid[len(valid) // 2:] = False
                return step(variables_list, acc, patches_u8, offsets, valid)
            out = step(variables_list, acc, patches_u8, offsets, valid)
            dx, dy = (int(v) for v in np.asarray(offsets)[0])
            acc[0, dx:dx + 8, dy:dy + 8] += 0.25  # one answer altered
            return out

        return wrapped

    monkeypatch.setattr(segmentation, "build_step", build_step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_program_is_not_correct(fault, tiny_bench, tmp_path,
                                       monkeypatch):
    broken(monkeypatch, fault)
    r = tiny(tiny_bench, tmp_path)
    assert r["correct"] is False


def test_fp8_control_is_not_correct(tiny_bench, tmp_path):
    r = tiny(tiny_bench, tmp_path, control="fp8")
    assert r["correct"] is False


def test_without_a_card_nothing_prints(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    p = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload",
         "dense-patch-resection", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=run.ROOT,
        env={**os.environ, "TMPDIR": str(tmp_path)}, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_card_control_fails_and_program_passes(card, seed, tmp_path):
    """On the card at the tiny size: the program passes and the float8
    reference in its place does not (the cells' own size: PERF.md)."""
    bench = run.HERE / "tests" / "data" / "BENCHMARK.json"
    ok = run.run("tiny", seed, 0.5, False, card, bench_path=bench,
                 workdir=tmp_path / "p")
    ctl = run.run("tiny", seed, 0.5, False, card, control="fp8",
                  bench_path=bench, workdir=tmp_path / "c")
    assert ok["correct"] is True and ctl["correct"] is False
