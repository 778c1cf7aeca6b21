"""The released recipe through the entry point on an HO3D fixture (the
files of ``tests/test_torch_real_slice.py``): ``python -m
artiboost_torch.train --cfg <config/ho3dv2_clasbased_artiboost.yaml with
DATA_ROOT on the fixture> --device cpu --epochs 1 --batch_size 4
--test_freq 1 --profile_dir DIR`` trains mixed batches (3 HO3D + 1 synth),
runs the TEST pass over every evaluation frame, and its trace names the real
batch's host half (``data/real_geometry`` and ``data/real_decode``, on the
producer's and the pool's rows), the step's wait for it
(``data/real_wait``) and its device half (``data/real_device``) apart."""
import glob
import json
import os

import numpy as np
import yaml

from tests.test_torch_real_slice import REPO, write_fixture


def test_released_recipe_trains_on_ho3d(tmp_path):
    """The acceptance command of the real-data path, in process."""
    from artiboost_torch import train
    from artiboost_torch.utils.config import load_config

    data = write_fixture(tmp_path)
    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    for split in ("TRAIN", "TEST"):
        cfg["DATASET"][split]["DATA_ROOT"] = data
    cfg_path = str(tmp_path / "released.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    parts = []
    orig = train.union_concat

    def union(p):
        parts.append([int(x["image"].shape[0]) for x in p])
        return orig(p)

    cwd = os.getcwd()
    os.chdir(tmp_path)
    train.union_concat = union
    try:
        out = train.main(["--cfg", cfg_path, "--device", "cpu", "--epochs", "1",
                          "--batch_size", "4", "--test_freq", "1", "--workers", "2",
                          "--profile_dir", str(tmp_path / "trace"), "--profile_steps", "2"])
    finally:
        train.union_concat = orig
        os.chdir(cwd)
    assert len(out["train_data"]) == 16 and len(out["test_data"]) == 20
    (record,) = out["history"]
    n_real, n_synth = out["loader"]._mixed_counts()
    assert n_real > 0 and n_synth > 0 and n_real + n_synth == 4
    assert record["train"]["steps"] == len(parts) == 6 and parts == [[n_real, n_synth]] * 6
    assert record["test"]["batches"] == 5 and record["test"]["images"] == 20
    assert all(np.isfinite(record["train"]["final_loss"]))
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("name", "").startswith("data/real_"):
            spans.setdefault(e["name"], set()).add(e["tid"])
    assert set(spans) == {"data/real_geometry", "data/real_decode", "data/real_wait",
                          "data/real_device"}, spans
    assert spans["data/real_geometry"].isdisjoint(spans["data/real_wait"])
