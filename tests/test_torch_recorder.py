"""The port's Recorder (``artiboost_torch/utils/recorder.py``) and
checkpoint/resume in ``artiboost_torch.train``: the experiment layout of
the JAX package's Recorder, the dirty-tree rule, a checkpoint round trip,
a resumed run against an uninterrupted one, and the ArtiBoost state read
back by the JAX Recorder.

Tolerance: bit equality throughout. The resumed run is pure synthesis
(``config/synthetic_smoke.yaml`` without DATASET.TRAIN), so every draw it
makes comes from the checkpointed loader generator."""
import copy
import glob
import json
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import artiboost_torch.utils.recorder as rec_mod
from artiboost_torch import train
from artiboost_torch.models.arch import Arch
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.recorder import Recorder

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per process while this file runs: the suite runs
    several workers on the host's cores, and a per-op thread pool in each
    of them oversubscribes the cores and makes these small ops several
    times slower. Every comparison here is made at one thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Eval:
    def get_measures_all(self):
        return {"Mean3DEPE": {"joints_3d_abs_mepe": 12.5}}

    def __str__(self):
        return "joints_3d_abs_mepe: 12.5000"


def test_layout_cfg_evaluator_and_arch(tmp_path):
    cfg = {"TRAIN": {"EPOCH": 1}, "DATA_PRESET": {"IMAGE_SIZE": [128, 128]}}
    rec = Recorder("default", cfg, root=str(tmp_path), timestamp="t")
    try:
        assert rec.dump_path == os.path.join(str(tmp_path), "default_t")
        for d in ("checkpoints", "evaluations"):
            assert os.path.isdir(os.path.join(rec.dump_path, d))
        with open(os.path.join(rec.dump_path, "dump_cfg.yaml")) as f:
            assert yaml.safe_load(f) == cfg
        assert rec.record_evaluator(_Eval(), 3, "val") == _Eval().get_measures_all()
        base = os.path.join(rec.eval_dir, "val_epoch_3")
        with open(base + ".json") as f:
            assert json.load(f) == {"Mean3DEPE": {"joints_3d_abs_mepe": 12.5}}
        with open(base + ".txt") as f:
            assert f.read() == "joints_3d_abs_mepe: 12.5000\n"
        arch = Arch([torch.nn.Identity(), torch.nn.Identity()], ["HybridBaseline", "MLP_O"],
                    [(), (0,)])
        rec.record_arch(arch)
        base = os.path.join(rec.dump_path, "arch")
        with open(base + ".txt") as f:
            assert f.read() == "nodes: HybridBaseline, MLP_O\nHybridBaseline -> MLP_O\n"
        with open(base + ".dot") as f:
            assert '"HybridBaseline" -> "MLP_O";' in f.read()
        assert os.path.getsize(base + ".png") > 0
        rec_mod.logger.warning("into the log")
    finally:
        rec.close()
    with open(os.path.join(rec.dump_path, "log.txt")) as f:
        assert "into the log" in f.read()
    # resuming keeps the directory and its dump_cfg.yaml
    again = Recorder("default", {"other": 1}, root=str(tmp_path), resume_path=rec.dump_path)
    again.close()
    with open(os.path.join(rec.dump_path, "dump_cfg.yaml")) as f:
        assert yaml.safe_load(f) == cfg


def test_named_experiment_dirty_tree_rule(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(rec_mod, "_git_commit", lambda: "abc123def4567890")
    monkeypatch.setattr(rec_mod, "_git_dirty", lambda: True)
    with pytest.raises(RuntimeError, match="UNCOMMITTED"):
        Recorder("named", {}, root=str(tmp_path), timestamp="a")
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        Recorder("named", {}, root=str(tmp_path), timestamp="b", allow_dirty=True).close()
    assert any("allow_dirty" in r.message for r in caplog.records)
    Recorder("default", {}, root=str(tmp_path), timestamp="c").close()  # unnamed: no rule
    monkeypatch.setattr(rec_mod, "_git_dirty", lambda: False)
    Recorder("named", {}, root=str(tmp_path), timestamp="d").close()
    monkeypatch.setattr(rec_mod, "_git_commit", lambda: None)
    caplog.clear()
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        Recorder("named", {}, root=str(tmp_path), timestamp="e").close()
    assert any("without a git commit" in r.message for r in caplog.records)


def _tiny_step(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    return SimpleNamespace(model=model, optimizer=opt, step=0)


def _ab_state(rng):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    return {"sample_weight_map": rng.rand(4, 48, 16).astype(np.float32),
            "occurrence_map": rng.randint(0, 9, (4, 48, 16)).astype(np.int32),
            "use_synth": False, "epoch_idx": 6, "rng_state": gen.get_state().numpy()}


def test_checkpoint_round_trip(tmp_path):
    step = _tiny_step(0)
    model = step.model.train()
    for _ in range(3):
        step.optimizer.zero_grad()
        model(torch.randn(8, 4)).square().sum().backward()
        step.optimizer.step()
        step.step += 1
    torch.manual_seed(123)
    rng_cpu = torch.get_rng_state()
    ab = _ab_state(np.random.RandomState(0))
    rec = Recorder("default", {}, root=str(tmp_path), timestamp="t")
    rec.record_checkpoints(step, epoch=4, artiboost_state=ab, snapshot=5)
    rec.close()
    ckpt = Path(rec.ckpt_dir)
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "artiboost_epoch_5.npz", "artiboost_latest.npz", "epoch_5.pt", "latest.pt",
        "synth_shutdown"]

    torch.rand(10)  # move the global generator on
    fresh = _tiny_step(1)
    rec = Recorder("default", {}, root=str(tmp_path), resume_path=rec.dump_path)
    assert rec.resume_checkpoints(fresh) == 5  # completed epochs
    rec.close()
    assert fresh.step == 3
    assert torch.equal(torch.get_rng_state(), rng_cpu)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    want, got = step.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    back = rec.resume_artiboost_state()
    assert back["use_synth"] is False
    for k in ("sample_weight_map", "occurrence_map", "epoch_idx", "rng_state"):
        np.testing.assert_array_equal(back[k], ab[k])
        assert back[k].dtype == np.asarray(ab[k]).dtype


def test_jax_recorder_reads_the_port_artiboost_state(tmp_path):
    from artiboost_tpu.utils.recorder import Recorder as JaxRecorder

    ab = dict(_ab_state(np.random.RandomState(1)), use_synth=True)
    rec = Recorder("default", {}, root=str(tmp_path), timestamp="t")
    rec.record_checkpoints(_tiny_step(0), epoch=0, artiboost_state=ab, snapshot=10)
    rec.close()
    jax_state = JaxRecorder("default", {}, resume_path=rec.dump_path).resume_artiboost_state()
    assert jax_state["use_synth"] is True
    for k in ("sample_weight_map", "occurrence_map", "epoch_idx"):
        np.testing.assert_array_equal(jax_state[k], ab[k])


def _pure_synth_cfg():
    cfg = load_config(str(REPO / "config" / "synthetic_smoke.yaml"))
    del cfg["DATASET"]["TRAIN"]
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=8, VAL_LEN=4)
    cfg["TRAIN"]["BATCH_SIZE"] = 4  # 2 steps and 1 val batch per epoch
    return cfg


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, monkeypatch):
    """2 epochs straight against 1 epoch, then ``--resume`` for the
    second, both through ``artiboost_torch.train``'s command line."""
    cfg = _pure_synth_cfg()
    straight = train.run(copy.deepcopy(cfg), epochs=2, device="cpu")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    train.main(["--cfg", str(path), "--device", "cpu", "--epochs", "1"])
    (exp,) = glob.glob("exp/default_*")
    first = torch.load(os.path.join(exp, "checkpoints", "latest.pt"), weights_only=True)
    assert first["epoch"] == 1
    train.main(["--resume", exp, "--device", "cpu", "--epochs", "2"])
    ckpt = os.path.join(exp, "checkpoints")
    resumed = torch.load(os.path.join(ckpt, "latest.pt"), weights_only=True)
    assert resumed["epoch"] == 2
    assert sorted(os.listdir(os.path.join(exp, "evaluations"))) == sorted(
        f"{s}_epoch_{e}.{x}" for s in ("train", "val") for e in (0, 1) for x in ("json", "txt"))

    model = straight["model"].state_dict()
    assert not all(torch.equal(first["model"][k], v) for k, v in model.items())
    for k, v in model.items():
        assert torch.equal(resumed["model"][k], v), k
    want = straight["step"].optimizer.state_dict()["state"]
    assert resumed["scheduler"]["step"] == straight["step"].step == 4
    for i, st in want.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed["optimizer"]["state"][i][k], st[k]), (i, k)
    with np.load(os.path.join(ckpt, "artiboost_latest.npz")) as ab:
        ccv = straight["loader"].ccv
        np.testing.assert_array_equal(ab["sample_weight_map"], ccv.sample_weight_map.numpy())
        np.testing.assert_array_equal(ab["occurrence_map"], ccv.occurrence_map.numpy())
        np.testing.assert_array_equal(ab["rng_state"],
                                      straight["loader"].generator.get_state().numpy())
    assert not bool(torch.all(straight["loader"].ccv.sample_weight_map == 1.0))
