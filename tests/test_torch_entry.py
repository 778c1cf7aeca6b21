"""The port's train entry point (``python -m artiboost_torch.train``) on
the CPU: the released recipe trains synth-only when its real data is
absent (the JAX package's ``FileNotFoundError`` fallback), ``--evaluate``,
``--batch_size``, the TEST pass, the summarizer's event file (against the
JAX package's flax ``Summarizer`` on the same evaluator, read back with
tensorboard's event reader) and the ``--profile_dir`` trace.

Tolerances: the summarizer's values at rtol 1e-6 (the evaluators agree to
that, tests/test_torch_metrics.py); everything else exact."""
import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from artiboost_torch import train
from artiboost_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
RELEASED = REPO / "config" / "ho3dv2_clasbased_artiboost.yaml"
SMOKE = REPO / "config" / "synthetic_smoke.yaml"
N_TEST, BATCH = 20, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per process while this file runs (the suite runs
    several workers on the host's cores; see tests/test_torch_recorder.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _in_dir(path, fn):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def small_smoke_config(path, with_test=True):
    """config/synthetic_smoke.yaml cut small: 16 SyntheticHO train samples
    at 128 x 128, CONFIG_LEN_TRAIN 16 (4 steps of 8 at --batch_size 8), one
    val batch, and a TEST split of 20 samples (batches of 8, 8 and a tail
    of 4 padded to 8)."""
    cfg = load_config(str(SMOKE))
    cfg["DATASET"]["TRAIN"].update(N_SAMPLES=16, RAW_SIZE=128)
    cfg["DATASET"]["TEST"].update(N_SAMPLES=N_TEST, RAW_SIZE=128)
    if not with_test:
        del cfg["DATASET"]["TEST"]
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=16, VAL_LEN=8)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """One run of the entry point: 2 epochs, --batch_size 8, --test_freq 1,
    a trace of epoch 0's steps 0-2; every TEST batch is recorded."""
    d = tmp_path_factory.mktemp("entry")
    cfg_path = small_smoke_config(d / "smoke.yaml")
    test_batches = []
    orig = train.padded_host_loader

    def recording_loader(dataset, batch_size, **kw):
        for batch in orig(dataset, batch_size, **kw):
            test_batches.append({k: batch[k].clone() for k in ("sample_idx", "sample_valid")
                                 if k in batch})
            yield batch

    train.padded_host_loader = recording_loader
    try:
        out = _in_dir(d, lambda: train.main([
            "--cfg", cfg_path, "--device", "cpu", "--epochs", "2", "--batch_size", str(BATCH),
            "--test_freq", "1", "--profile_dir", str(d / "trace"), "--profile_steps", "2"]))
    finally:
        train.padded_host_loader = orig
    return {"dir": d, "out": out, "dump": d / out["dump_path"], "test_batches": test_batches}


def test_released_config_trains_synth_only(tmp_path, caplog):
    """C.1: config/ho3dv2_clasbased_artiboost.yaml with no ./data trains
    synth-only and skips the TEST passes, with the JAX package's warnings
    (train_artiboost.py:242-254), and its evaluator builds every metric."""
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        out = _in_dir(tmp_path, lambda: train.main([
            "--cfg", str(RELEASED), "--device", "cpu", "--epochs", "1", "--batch_size", "2"]))
    msgs = [r.message for r in caplog.records]
    assert ("train dataset unavailable (HO3D data not found under ./data/HO3D/train); "
            "synth-only training") in msgs
    assert ("test dataset unavailable (HO3D data not found under ./data/HO3D/evaluation); "
            "skipping test passes") in msgs
    assert not [m for m in msgs if m.startswith("metric ")], msgs  # every metric is built
    assert out["train_data"] is None and out["test_data"] is None
    assert out["loader"]._mixed_counts() == (0, 2)
    (record,) = out["history"]
    assert record["train"]["steps"] == 1 and "test" not in record
    assert [type(m).__name__ for m in out["evaluator"].metrics_list] == \
        [m["TYPE"] for m in load_config(str(RELEASED))["EVALUATOR"]]
    evals = tmp_path / out["dump_path"] / "evaluations"
    with open(evals / "train_epoch_0.json") as f:
        measures = json.load(f)
    for name in ("Hand3DPCKMetric", "Obj3DPCKMetric"):
        assert 0.0 <= measures[name]["auc_all"] <= 1.0 and measures[name]["epe_mean_all"] > 0
    assert set(measures) == {"LossesMetric", "Hand3DPCKMetric", "Obj3DPCKMetric", "Mean3DEPE",
                             "ValMetricMean3DEPE2"}
    from PIL import Image

    with Image.open(evals / "train_epoch_0_Vis2DMetric.png") as im:
        assert im.size == (6 * 224, 6 * 224)
    assert not glob.glob(str(evals / "test_*"))


RECIPES = {"reg": REPO / "config" / "ho3dv2_regbased_artiboost.yaml",
           "dexycb_sym": REPO / "config" / "dexycb_clasbased_sym_artiboost.yaml"}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_other_released_recipes_train_synth_only(recipe, tmp_path, caplog):
    """The Reg recipe (HOPRegNet, ManoLoss) and the symmetric DexYCB recipe
    (SymCornerLoss, AR, ValMetricAR2) with no ./data: synth-only, no TEST
    passes, every loss and metric built. The DexYCB recipe's absent
    MODEL_INFO_PATH degrades to identity symmetries with a warning, and it
    writes AR and ``val_mssd_mean`` into its evaluation JSON and its
    TensorBoard tags."""
    path = RECIPES[recipe]
    cfg = load_config(str(path))
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        out = _in_dir(tmp_path, lambda: train.main([
            "--cfg", str(path), "--device", "cpu", "--epochs", "1", "--batch_size", "2"]))
    msgs = [r.message for r in caplog.records]
    data = cfg["DATASET"]["TRAIN"]["TYPE"]
    assert any(m.startswith(f"train dataset unavailable ({data} data not found under ")
               and m.endswith("); synth-only training") for m in msgs), msgs
    assert any(m.startswith(f"test dataset unavailable ({data} data not found under ")
               and m.endswith("); skipping test passes") for m in msgs), msgs
    assert not [m for m in msgs if m.startswith("metric ")], msgs  # every metric is built
    absent_info = [m for m in msgs if m.startswith("MODEL_INFO_PATH")]
    assert bool(absent_info) == (recipe == "dexycb_sym")
    assert out["train_data"] is None and out["test_data"] is None
    (record,) = out["history"]
    assert record["train"]["steps"] == 1 and "test" not in record
    assert np.isfinite(record["train"]["final_loss"]).all()
    assert type(out["model"].model_list[0]).__name__ == cfg["ARCH"]["TYPE"]
    assert [type(m).__name__ for m in out["evaluator"].metrics_list] == \
        [m["TYPE"] for m in cfg["EVALUATOR"]]
    assert [type(m).__name__ for m in out["step"].criterion.loss_list] == \
        [c["TYPE"] for c in cfg["CRITERION"]]
    dump = tmp_path / out["dump_path"]
    with open(dump / "evaluations" / "train_epoch_0.json") as f:
        measures = json.load(f)
    assert set(measures) == {m["TYPE"] for m in cfg["EVALUATOR"]} - {"Vis2DMetric"}
    tags = {t for t, _ in read_scalars(dump / "runs")}
    if recipe == "dexycb_sym":
        assert 0.0 <= measures["AR"]["AR_MSSD"] <= 1.0 and measures["AR"]["MSSD"] > 0
        assert np.isfinite(measures["ValMetricAR2"]["val_mssd_mean"])
        assert measures["LossesMetric"]["sym_corners_3d_loss"] > 0
        assert {"train/AR/AR_MSSD", "train/AR/MSSD", "train/ValMetricAR2/val_mssd_mean"} <= tags
    else:
        assert {"mano_shape", "mano_pca_pose"} <= set(measures["LossesMetric"])
        assert "train/LossesMetric/mano_pca_pose" in tags


REAL_TYPES = [("HO3D", {"DATA_SPLIT": "train", "SPLIT_MODE": "paper"}),
              ("HO3D", {"DATA_SPLIT": "test", "SPLIT_MODE": "paper"}),
              ("HO3DV3", {"DATA_SPLIT": "train", "SPLIT_MODE": "paper"}),
              ("DexYCB", {"DATA_SPLIT": "train", "SPLIT_MODE": "s0"}),
              ("FPHB", {"DATA_SPLIT": "train", "SPLIT_MODE": "subjects"})]


@pytest.mark.parametrize("kind,node", REAL_TYPES)
def test_missing_real_data_raises_as_jax_does(kind, node, tmp_path):
    """An absent data root raises the JAX package's FileNotFoundError, word
    for word; once the directory the message names exists, the port builds
    what the JAX package builds on it: an empty dataset (or the same
    exception with the same message)."""
    import artiboost_tpu.datasets  # noqa: F401  (registers the dataset types)
    from artiboost_torch.datasets.synthetic import build_dataset, missing_real_data
    from artiboost_tpu.utils.registry import DATASET, build_from_cfg

    node = dict(node, TYPE=kind, DATA_ROOT=str(tmp_path / "data"))
    preset = dict(load_config(str(RELEASED))["DATA_PRESET"], USE_CACHE=False)
    with pytest.raises(FileNotFoundError) as want:
        build_from_cfg(dict(node), DATASET, {"DATA_PRESET": preset})
    with pytest.raises(FileNotFoundError) as got:
        build_dataset(node, preset, device="cpu")
    assert str(got.value) == str(want.value)
    probe = str(got.value).split(" under ")[1]
    os.makedirs(os.path.join(probe, "Hand_pose_annotation_v1") if kind == "FPHB" else probe)
    assert missing_real_data(kind, node) is None

    def build(fn):
        try:
            return len(fn())
        except Exception as e:  # the JAX package's own outcome on the probe
            return type(e), str(e)

    want = build(lambda: build_from_cfg(dict(node), DATASET, {"DATA_PRESET": preset}))
    got = build(lambda: build_dataset(node, preset, device="cpu"))
    assert got == want == 0


def test_batch_size_overrides_the_config(smoke_run):
    with open(smoke_run["dump"] / "dump_cfg.yaml") as f:
        assert yaml.safe_load(f)["TRAIN"]["BATCH_SIZE"] == BATCH
    hist = smoke_run["out"]["history"]
    assert [r["train"]["steps"] for r in hist] == [4, 4]
    assert all(r["train"]["images"] == 4 * BATCH for r in hist)
    assert smoke_run["out"]["loader"]._mixed_counts() == (4, 4)


def test_test_pass_covers_every_sample_once(smoke_run):
    """Two TEST passes (--test_freq 1, 2 epochs), each over all 20 samples:
    batches of 8, 8 and 4 + 4 repeat-padded rows masked by SAMPLE_VALID;
    the losses are weighted by the valid count."""
    batches = smoke_run["test_batches"]
    assert len(batches) == 6
    for p in range(2):
        seen = []
        for b in batches[3 * p:3 * p + 3]:
            valid = b.get("sample_valid", torch.ones(BATCH))
            seen += b["sample_idx"][valid > 0].tolist()
        assert sorted(seen) == list(range(N_TEST))
    assert "sample_valid" not in batches[0] and batches[2]["sample_valid"].tolist() == \
        [1.0] * 4 + [0.0] * 4
    hist = smoke_run["out"]["history"]
    for r in hist:
        assert r["test"]["batches"] == 3 and r["test"]["images"] == N_TEST
        assert set(r["test"]["measures"]) == {"LossesMetric", "Mean3DEPE"}
    losses = smoke_run["out"]["test_evaluator"].losses_metric
    assert set(losses.counts.values()) == {N_TEST}
    for epoch in (0, 1):
        with open(smoke_run["dump"] / "evaluations" / f"test_epoch_{epoch}.json") as f:
            assert json.load(f) == hist[epoch]["test"]["measures"]


def test_evaluate_runs_one_test_pass(smoke_run):
    """--resume <dir> --evaluate: one TEST pass of the resumed model,
    recorded at the resumed epoch, and no training."""
    d = smoke_run["dir"]
    out = _in_dir(d, lambda: train.main(["--resume", str(smoke_run["dump"]), "--device", "cpu",
                                         "--evaluate"]))
    assert [set(r) for r in out["history"]] == [{"epoch", "test"}]
    assert out["history"][0]["epoch"] == 2 and out["history"][0]["test"]["batches"] == 3
    assert out["step"].step == 8  # the resumed schedule, untouched
    with open(smoke_run["dump"] / "evaluations" / "test_epoch_2.json") as f:
        assert json.load(f) == out["history"][0]["test"]["measures"]


def test_evaluate_needs_a_test_split(tmp_path):
    cfg_path = small_smoke_config(tmp_path / "no_test.yaml", with_test=False)
    with pytest.raises(RuntimeError, match="--evaluate requires a TEST dataset"):
        _in_dir(tmp_path, lambda: train.main(["--cfg", cfg_path, "--device", "cpu",
                                              "--batch_size", str(BATCH), "--evaluate"]))


def read_scalars(run_dir) -> dict:
    """{(tag, step): value} of every scalar in the event files under
    ``run_dir``, whichever way the writer stored it."""
    from tensorboard.backend.event_processing.event_file_loader import LegacyEventFileLoader
    from tensorboard.util import tensor_util

    out = {}
    for path in sorted(glob.glob(os.path.join(str(run_dir), "events.out.tfevents.*"))):
        for ev in LegacyEventFileLoader(path).Load():
            for v in ev.summary.value:
                val = (float(tensor_util.make_ndarray(v.tensor)) if v.HasField("tensor")
                       else float(v.simple_value))
                out[(v.tag, int(ev.step))] = val
    return out


def test_summarizer_matches_the_jax_package(tmp_path):
    """The same losses and the same evaluator (fed the same batches on both
    sides) through the port's Summarizer and the JAX package's: the same
    tags at the same steps, values at rtol 1e-6."""
    from artiboost_torch.utils.summarizer import Summarizer
    from artiboost_tpu.utils.summarizer import Summarizer as JaxSummarizer
    from tests.test_torch_metrics import fed_evaluators

    j_ev, t_ev = fed_evaluators()
    losses = {"final_loss": 0.25, "joints_3d_loss": 0.125, "unused": None}
    for summ, ev in ((JaxSummarizer(str(tmp_path / "jax")), j_ev),
                     (Summarizer(str(tmp_path / "torch")), t_ev)):
        summ.summarize_losses(losses, 40, prefix="train")
        summ.summarize_evaluator(ev, 3, "val")
        summ.close()
    want, got = read_scalars(tmp_path / "jax" / "runs"), read_scalars(tmp_path / "torch" / "runs")
    assert sorted(got) == sorted(want)
    assert ("train/loss/final_loss", 40) in got and ("val/Hand3DPCKMetric/auc_all", 3) in got
    assert ("val/ValMetricMean3DEPE2/val_epe_mean", 3) in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0, err_msg=str(key))


def test_run_summarizes_every_pass(smoke_run):
    got = read_scalars(smoke_run["dump"] / "runs")
    tags = {t for t, _ in got}
    for split in ("train", "val", "test"):
        assert f"{split}/LossesMetric/final_loss" in tags and \
            f"{split}/Mean3DEPE/joints_3d_abs_mepe" in tags
        assert {s for t, s in got if t == f"{split}/LossesMetric/final_loss"} == {0, 1}
    assert "val/ValMetricMean3DEPE2/val_epe_mean" in tags
    # the losses at train steps 0 of each epoch (LOG_EVERY 20), after the step
    assert {s for t, s in got if t == "train/loss/final_loss"} == {1, 5}
    hist = smoke_run["out"]["history"]
    np.testing.assert_allclose(got[("train/loss/final_loss", 5)], hist[1]["train"]["final_loss"][0],
                               rtol=1e-6)


def test_profile_dir_writes_a_chrome_trace(smoke_run):
    (path,) = glob.glob(str(smoke_run["dir"] / "trace" / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    # epoch 0's pose sweep; the trace ended at step 2 of epoch 0, before the val sweep's
    assert names.count("engine/sweep") == 1
    assert sorted(n for n in names if n.startswith("train#")) == ["train#0", "train#1", "train#2"]
    assert names.count("artiboost/train_step") == 3
    assert "raster/prepare_raster" in names


def test_snapshot_default_is_the_jax_packages(smoke_run):
    """--snapshot defaults to 50 (artiboost_tpu/opt.py:41): a 2-epoch run
    keeps only latest.pt."""
    ckpts = sorted(os.listdir(smoke_run["dump"] / "checkpoints"))
    assert "latest.pt" in ckpts and not [c for c in ckpts if c.startswith("epoch_")]
