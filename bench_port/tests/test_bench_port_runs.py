"""Whole runs of the harness at a small size on the CPU (the look for a
card skipped): the last line's keys, the control and each fault a cell
can have coming out as not correct, and on a card the cells themselves."""
import json
import math

import pytest

from bench_port import run
from bench_port.tests.conftest import SMALL

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
SEED = 4294967296123
TRAIN, VAL = "clas-ho3dv2.train-synth", "clas-sym-dexycb.val"
# the DexYCB val sweep is not listed in BENCHMARK.json while the program's
# texel fetch can index past its atlas (PERF.md, open questions)
VAL_DEF = {"name": VAL, "config": "clas-sym-dexycb", "traffic": "val", "chips": 1}
SYNTH = ["pose_gap_mm", "labels_gap_mm", "labels_gap_px", "screen_gap_px", "image_mismatch",
         "raster_mismatch", "mano_gap_mm", "reweight_gap"]


def small_run(cell, cache, **kw):
    return run.run_cell(cell, SEED, 0.0, False, device="cpu", cache=cache, **SMALL, **kw)


def limits(cell):
    return run.load_json(run.BENCH, "workloads", f"{cell}.json")["check"]["limits"]


def over(numbers, cell, keys):
    lim = limits(cell)
    return [k for k in keys if numbers[k] > lim[k]]


def test_last_line_train_and_control(small_cache):
    out = small_run(TRAIN, small_cache, variants=("program", "control"))
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_img_s", "setup_s"}
    assert all(m["value"] > 0 and math.isfinite(m["value"]) for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert json.loads(json.dumps(res)) == res
    # the control fails the model's numbers and every stage's
    assert over(out["readings"]["control"], TRAIN, ["joints_med_vs_bf16"])
    assert over(out["readings"]["control"], TRAIN, SYNTH) == SYNTH


@pytest.mark.parametrize("fault,caught", [
    ("unchanged_state", ["change_med_vs_bf16", "win_change_med_vs_bf16"]),
    ("half_batch", ["win_loss_gap1"]),
    ("perturbed_answer", ["joints_med_vs_bf16"]),
    ("refiner_short", ["pose_gap_mm"])])
def test_train_faults_come_out_not_correct(small_cache, fault, caught):
    out = small_run(TRAIN, small_cache, fault=fault)
    assert out["result"]["correct"] is False
    assert over(out["readings"]["program"], TRAIN, caught) == caught


def test_val_control_and_altered_answer(small_cache):
    out = small_run(VAL, small_cache, variants=("program", "control"), cell_def=VAL_DEF)
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert set(out["result"]["metrics"]) == {"val_img_s", "setup_s"}
    keys = ["joints_med_vs_bf16", "epe_map_med_vs_bf16", "mssd_map_med_vs_bf16"] + SYNTH
    assert over(out["readings"]["control"], VAL, keys) == keys
    bad = small_run(VAL, small_cache, fault="perturbed_answer", cell_def=VAL_DEF)
    assert bad["result"]["correct"] is False
    assert over(bad["readings"]["program"], VAL, ["joints_med_vs_bf16", "epe_map_med_vs_bf16"])


@pytest.mark.card
@pytest.mark.parametrize("cell,cell_def", [(TRAIN, None), (VAL, VAL_DEF)])
def test_cell_on_the_card(card, cell, cell_def):
    out = run.run_cell(cell, SEED, 1.0, False, cell_def=cell_def)
    assert out["result"]["correct"] is True, out["result"]["checks"]


def test_dp4_exchange_left_out(small_cache, monkeypatch):
    """Cell 1's traffic on 4 CPU ranks joined by gloo (a cell not listed in
    BENCHMARK.json yet): the global step held against the one-device
    reference; without the gradient exchange it is not correct."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cell = "clas-ho3dv2.train-synth.dp4"
    kw = dict(device="cpu", cache=small_cache, asset_sizes=SMALL["asset_sizes"],
              cell_def={"name": cell, "config": "clas-ho3dv2", "traffic": "train-synth-dp4",
                        "chips": 4},
              overrides=dict(SMALL["overrides"], **{"TRAIN.BATCH_SIZE": 8,
                                                    "MANAGER.CONFIG_LEN_TRAIN": 24}))
    out = run.run_ranks(cell, SEED, 0.0, False, 4, **kw)
    assert out["result"]["device"]["count"] == 4
    assert out["result"]["correct"] is True, out["result"]["checks"]
    assert set(out["result"]["metrics"]) == {"train_img_s", "setup_s"}
    bad = run.run_ranks(cell, SEED, 0.0, False, 4, fault="no_exchange", **kw)
    assert bad["result"]["correct"] is False
    assert over(bad["readings"]["program"], cell, ["rank_spread"])
