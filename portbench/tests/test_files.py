"""Every file BENCHMARK.json names is found by its name and parses."""

import importlib.util
import json

import pytest

from portbench import judge, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    bench, entry, config, traffic = run.load_cell(cell)
    assert entry["config"] == config["name"]
    for key in ("slide", "warmup", "engine", "min_slides", "limits"):
        assert key in traffic
    assert set(traffic["limits"]) <= set(judge.NAMES)
    exact = {"count_bad_px", "mask_bad_px", "tiff_levels_bad"}
    assert exact <= set(traffic["limits"])
    assert all(traffic["limits"][k] == 0 for k in exact)
    kw = run.engine_kwargs(config, traffic, "cpu")
    assert kw["data_parallel"] is False and kw["device"] == "cpu"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(run.metric_reader(metric))


def test_every_config_file_is_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert json.loads((run.ROOT / c["file"]).read_text())["name"] == \
            c["name"]


def test_each_cell_reports_setup_and_another_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, w["name"], True)


def test_reference_has_every_model():
    for c in BENCH["configs"]:
        config = json.loads((run.ROOT / c["file"]).read_text())
        mods = run.reference_modules(config)
        assert set(mods) == set(config["models"])
        for m in mods.values():
            assert callable(m.shapes) and callable(m.forward)
    assert importlib.util.find_spec("portbench.reference.plan")
