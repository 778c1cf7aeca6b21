"""The harness finds every cell, configuration and metric by name from
its files alone, and BENCHMARK.json keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from bench_port import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_from_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = run.find_cell(cell)
    cfg = run.load_json(run.BENCH, "configs", f"{w['config']}.json")
    assert set(run.load_json(run.BENCH, "workloads", f"{cell}.json")) == {"check"}
    mod = run.load_module("entries", w["mix"]["entry"])
    assert set(w["mix"]) <= mod.TRAFFIC and set(w["check"]["limits"]) >= {
        "raster_mismatch", "mano_gap_mm", "reweight_gap", "pose_gap_mm", "image_mismatch"}
    recipe = run.recipe_for(w, cfg, 123)
    assert recipe["TRAIN"]["BATCH_SIZE"] == w["mix"]["recipe"]["TRAIN.BATCH_SIZE"]
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and len(entry["why"]) <= 200
    run.load_module("reference", recipe["ARCH"]["TYPE"])


def test_unknown_traffic_keys_are_refused(tmp_path, monkeypatch):
    """A key of a traffic file that the entry does not read stops the run."""
    cell = BENCH["workloads"][0]
    mix = dict(run.find_cell(cell["name"])["mix"], mode="mixed")
    monkeypatch.setattr(run, "find_cell", lambda name, cell_def=None: dict(
        cell, check={}, mix=mix))
    with pytest.raises(ValueError, match="mode"):
        run.run_cell(cell["name"], 1, 0.0, False, device="cpu")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    data = run.load_json(run.ROOT, c["file"])
    assert data["name"] == config and data["source"] == c["source"]
    assert sorted(data["reduced"]) == sorted(c["reduced"]) and len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    for key in c["reduced"]:  # every cut key is set in the recipe as it runs
        node = data["recipe"]
        for part in key.split("."):
            node = node[part]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_by_name(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = run.load_reader(metric)
    assert callable(mod.read)
    assert NAME.match(metric) and UNIT.match(m["unit"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert all(c in e2e[m["moves"]].get("workloads", [c]) for c in m["workloads"])


def test_end_to_end_metrics():
    names = [e["name"] for e in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    cells = [w["name"] for w in BENCH["workloads"]]
    for c in cells:  # every cell reports setup_s, another end-to-end and a per-layer metric
        assert sum(c in e.get("workloads", cells) for e in BENCH["end_to_end"]) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
