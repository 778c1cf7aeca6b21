"""The submission over two ranks on the CPU: ``python -m
artiboost_torch.submit_reload --n_devices 2 --device cpu --submit_dump
--postprocess_fit_mesh`` (two gloo ranks spawned by the entry point)
against the same command in one process.

The input is ``tests/test_torch_submit.py``'s ``SyntheticHO`` fixture (the
released HO3D evaluation config with the arch cut to ResNet18 at 64 x 64, 8
x 8 heatmaps) at 10 frames and batch 4: two full batches and a tail of 2
padded to 4, so rank 0 holds the tail's two frames and rank 1 two padded
rows. The weights are a checkpoint of a seeded initialisation.

Bounds:
- the dumped JSON holds ``len(dataset)`` joint and vert rows in both, in
  the dataset's order;
- joints and fitted verts within 2e-5 m: two steps of the dump's 5-decimal
  rounding (each rank convolves and fits 2 rows in place of 4, which moves
  a value's last float32 bits and can flip its rounding; measured: the
  joints equal, the verts one step apart);
- every measure within 1e-5 relative or 1e-8 absolute, whichever is
  larger. The floor is for ``part_ord_loss`` alone, the one measure below
  1e-3 of its metric's largest: it reads 1e-9, a hinge over ordinal pairs
  whose margins are float noise, and parts by 3e-13 to 1.8e-12 between the
  two runs (1.7e-3 relative) as the rows' last bits move;
- the ranks' parameters and buffers after the load the same bits
  (each rank's sha256, as the entry point logs it).

A batch that does not tile two ranks (3) evaluates in one process, says
why, and returns ``ranks`` 1. Each process has a timeout of 150 s and the
ranks' process group one of 300 s."""
import ast
import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from artiboost_torch import submit_reload
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel import mesh
from artiboost_torch.utils.config import load_config
from tests._proc import subprocess_env

REPO = Path(__file__).resolve().parents[1]
CFG_EVAL = REPO / "config_eval" / "eval_ho3dv2_clasbased_artiboost.yaml"
CFG_SMOKE = REPO / "config" / "synthetic_smoke.yaml"
N_FRAMES, BATCH = 10, 4
PROC_TIMEOUT_S = 150
DIGESTS = "each rank's state after the load (sha256): "


def _config() -> dict:
    cfg = load_config(str(CFG_EVAL))
    smoke = load_config(str(CFG_SMOKE))
    cfg["DATASET"]["TEST"] = {"TYPE": "SyntheticHO", "DATA_SPLIT": "test", "AUG": False,
                              "AUG_PARAM": None, "N_SAMPLES": N_FRAMES, "SEED": 11,
                              "RAW_SIZE": 256}
    cfg["ARCH"] = dict(copy.deepcopy(smoke["ARCH"]), PRETRAINED=None)
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["TRAIN"]["BATCH_SIZE"] = BATCH
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank and the 1-process command, started together."""
    d = tmp_path_factory.mktemp("submit_dp")
    cfg = _config()
    with open(d / "eval.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        arch = build_arch(cfg["ARCH"], cfg["DATA_PRESET"])
    torch.save({"epoch": 0, "model": arch.state_dict()}, d / "latest.pt")
    env = subprocess_env()
    procs = {}
    for name, extra in (("two", ["--n_devices", "2"]), ("one", [])):
        (d / name).mkdir()
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "artiboost_torch.submit_reload", "--cfg", str(d / "eval.yaml"),
             "--reload", str(d / "latest.pt"), "--device", "cpu", "--exp_id", name,
             "--submit_dump", "--postprocess_fit_mesh"] + extra,
            cwd=d / name, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {"dir": d, "cfg": cfg}
    try:
        for name, p in procs.items():
            log = p.communicate(timeout=PROC_TIMEOUT_S)[0]
            assert p.returncode == 0, log[-4000:]
            exp = d / name / "exp"
            (run,) = exp.iterdir()
            with open(run / "pred_syntheticho.json") as f:
                xyz, verts = json.load(f)
            with open(run / "evaluations" / "test_epoch_0.json") as f:
                measures = json.load(f)
            digests = [ast.literal_eval(line.split(DIGESTS)[1]) for line in log.splitlines()
                       if DIGESTS in line]
            out[name] = {"log": log, "xyz": np.asarray(xyz), "verts": np.asarray(verts),
                         "measures": measures, "digests": digests}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_ranks_dump_the_rows_of_one_process(runs):
    two, one = runs["two"], runs["one"]
    assert two["xyz"].shape == one["xyz"].shape == (N_FRAMES, 21, 3)
    assert two["verts"].shape == one["verts"].shape == (N_FRAMES, 778, 3)
    np.testing.assert_allclose(two["xyz"], one["xyz"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(two["verts"], one["verts"], atol=2e-5, rtol=0)
    # the dataset's order: every row is its own frame's, none repeated
    gaps = np.abs(one["xyz"][:, None] - two["xyz"][None]).max(axis=(2, 3))
    assert (gaps.argmin(axis=1) == np.arange(N_FRAMES)).all()
    assert len({r.tobytes() for r in one["xyz"]}) == N_FRAMES


def test_two_ranks_measures(runs):
    two, one = runs["two"]["measures"], runs["one"]["measures"]
    assert set(two) == set(one) and {"Mean3DEPE", "LossesMetric"} <= set(one)
    for metric, vals in one.items():
        assert set(two[metric]) == set(vals)
        for k, v in vals.items():
            got = two[metric][k]
            assert abs(got - v) <= max(1e-5 * abs(v), 1e-8), (metric, k, got, v)


def test_two_ranks_load_the_same_bits(runs):
    (two,), (one,) = runs["two"]["digests"], runs["one"]["digests"]
    assert len(two) == 2 and len(set(two)) == 1 and two == one * 2
    assert "2 rank(s)" in runs["two"]["log"] and "1 rank(s)" in runs["one"]["log"]


def test_batch_that_does_not_tile_runs_in_one_process(runs, monkeypatch, caplog):
    def spawn(*a, **k):
        raise AssertionError("a batch of 3 must not spawn 2 ranks")

    monkeypatch.setattr(mesh, "spawn_ranks", spawn)
    monkeypatch.chdir(runs["dir"])
    out = submit_reload.main(["--cfg", "eval.yaml", "--reload", "latest.pt", "--device", "cpu",
                              "--exp_id", "tail", "--n_devices", "2", "--batch_size", "3"])
    assert out["ranks"] == 1 and out["batches"] == 4 and len(out["param_digests"]) == 1
    assert any("does not tile 2 ranks: one process evaluates" in r.getMessage()
               for r in caplog.records)
