"""The mining experiment scripts (``artiboost_torch/scripts/mining_planted.py``
and ``mining_ab.py``) against the JAX package's ``script/mining_planted.py``
and ``script/mining_ab.py``.

- ``corrupt`` and ``offset`` on one fixed synth batch equal JAX's
  ``corrupt_wrap`` and ``offset_wrap`` on the same arrays, the noise JAX
  draws from its key injected: within 1e-7 m (XLA may contract the
  noise's multiply-add; measured bit-equal here).
- The planted regions over the CCV space equal JAX's (``region_mask_fn``
  for ``noise``; object 0 for ``withhold`` and ``offset``), and so does
  ``withhold``'s masked weight map; a draw from it holds no object 0.
- Each script's ``main`` runs 2 epochs at a small size on the CPU
  (``config/mining_ab.yaml`` at batch 4, 64 x 64: 8 SyntheticHO train
  samples and CONFIG_LEN_TRAIN 8, 4 steps an epoch, VAL_LEN 8) and prints
  one well-formed JSON line per run and its summary; ``uniform``'s mass
  ratio is exactly 1.000.
"""
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from artiboost_torch.scripts import mining_ab, mining_planted as planted
from artiboost_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "script" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synth_batch(rng, B=12, V=48):
    return {"obj_id": rng.randint(0, 4, B).astype(np.int32),
            "persp_id": rng.randint(0, V, B).astype(np.int32),
            "joints_3d": (rng.randn(B, 21, 3) * 0.05).astype(np.float32),
            "corners_3d": (rng.randn(B, 8, 3) * 0.05).astype(np.float32)}


def test_noise_plant_against_jax():
    j = _jax_script("mining_planted")
    rng = np.random.RandomState(0)
    batch = _synth_batch(rng)
    batch["obj_id"][:3] = 0
    batch["persp_id"][:3] = [0, 11, 12]  # in, in, out of the first quarter
    v_cut, sigma, seed = 48 // 4, 0.1, 3
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = j.corrupt_wrap(lambda k, gen, sidx: jbatch, v_cut, sigma, seed)(key, None, None)
    k1, k2 = jax.random.split(jax.random.fold_in(key, seed + planted.NOISE_SEED_OFFSET))
    jn = np.asarray(jax.random.normal(k1, batch["joints_3d"].shape)) * np.float32(sigma)
    cn = np.asarray(jax.random.normal(k2, batch["corners_3d"].shape)) * np.float32(sigma)
    got = planted.corrupt({k: torch.from_numpy(v) for k, v in batch.items()}, v_cut,
                          torch.from_numpy(jn), torch.from_numpy(cn))
    hard = (batch["obj_id"] == 0) & (batch["persp_id"] < v_cut)
    assert hard[:2].all() and not hard[2] and 0 < hard.sum() < len(hard)
    for k in ("joints_3d", "corners_3d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-7, rtol=0)
        moved = (got[k].numpy() != batch[k]).any(axis=(1, 2))
        assert (moved == hard).all(), k
    assert got["obj_id"] is not None and torch.equal(got["obj_id"],
                                                     torch.from_numpy(batch["obj_id"]))


def test_offset_plant_against_jax():
    j = _jax_script("mining_planted")
    batch = _synth_batch(np.random.RandomState(1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = j.offset_wrap(lambda k, gen, sidx: jbatch, 0.03)(jax.random.PRNGKey(0), None, None)
    got = planted.offset({k: torch.from_numpy(v) for k, v in batch.items()},
                         planted.offset_vector(0.03, "cpu"))
    for k in ("joints_3d", "corners_3d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(np.linalg.norm(planted.OFFSET_DIR)), 1.0, rtol=1e-12)


@pytest.mark.parametrize("plant", ["noise", "withhold", "offset"])
def test_regions_and_withhold_mask_against_jax(plant):
    j = _jax_script("mining_planted")
    O, V, G = 4, 48, 16
    oid, vid = np.meshgrid(np.arange(O), np.arange(V), indexing="ij")
    if plant == "noise":
        mask_fn, v_cut = j.region_mask_fn(V)
        assert v_cut == V // 4
    else:  # the JAX script's inline mask for these plants (:175-184)
        def mask_fn(obj_id, persp_id):
            return obj_id == j.HARD_OBJ
    want = np.zeros((O, V, G), bool)
    want[np.asarray(mask_fn(oid, vid))] = True
    got = planted.region_grid((O, V, G), plant)
    assert (got == want).all() and 0 < got.sum() < got.size
    # withhold's masked draw: the weight map as JAX masks it (:215-217)
    w = np.random.RandomState(2).uniform(0.1, 10, (O, V, G)).astype(np.float32)
    jmasked = np.asarray(jnp.where(jnp.asarray(want), 0.0, jnp.asarray(w)))
    t = torch.from_numpy(w)
    tmasked = torch.where(torch.from_numpy(got), torch.zeros_like(t), t)
    assert np.array_equal(tmasked.numpy(), jmasked)


def _small_cfg(tmp_path) -> str:
    cfg = load_config(str(REPO / "config" / "mining_ab.yaml"))
    cfg["DATASET"]["TRAIN"].update(N_SAMPLES=8, RAW_SIZE=64)
    cfg["DATASET"]["TEST"].update(N_SAMPLES=8, RAW_SIZE=64)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=8, VAL_LEN=8)
    cfg["MANAGER"]["RENDERER"].update(RENDER_SIZE=[128, 128],
                                      CAM_PARAM={"FX": 218.0, "FY": 218.0, "CX": 64.0,
                                                 "CY": 64.0})
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["ARCH"]["HYBRID_HEAD"].update(NUM_DECONV_FILTERS=[32, 32], DEPTH_RESOLUTION=8)
    cfg["TRAIN"]["BATCH_SIZE"] = 4
    path = tmp_path / "mining_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _finite(row):
    return all(math.isfinite(v) for v in row.values() if isinstance(v, float))


def test_mining_planted_main_runs(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the blacklist cache goes under common/cache
    # the withhold plant's masked draw, counted: object 0 is never drawn
    from artiboost_torch.artiboost.loader import ArtiBoostLoader

    drawn = []
    prepare = ArtiBoostLoader.prepare

    def spy(self):
        prepare(self)
        drawn.append(self.generated.obj_id.clone())

    out = planted.main(["--plant", "noise", "--epochs", "2", "--seeds", "1",
                        "--cfg", _small_cfg(tmp_path), "--device", "cpu"])
    with monkeypatch.context() as m:
        m.setattr(ArtiBoostLoader, "prepare", spy)
        held = planted.main(["--plant", "withhold", "--epochs", "2", "--seeds", "1",
                             "--methods", "uniform", "--release_frac", "0.5",
                             "--cfg", _small_cfg(tmp_path), "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    rows = [r for r in lines if "seed" in r]
    assert [(r["plant"], r["method"]) for r in rows] == [
        ("noise", "method_1"), ("noise", "uniform"), ("withhold", "uniform")]
    assert rows == out["rows"] + held["rows"]
    keys = {"method", "seed", "epochs", "plant", "sigma_mm", "release_epoch", "train_s",
            "region_frac_uniform", "region_weight_mass", "mass_ratio_vs_uniform",
            "val_epe_region_mm", "val_epe_rest_mm", "region_draw_frac_post_release",
            "dist_lower_ratio", "val_region_traj", "val_epochs"}
    for r in rows:
        assert set(r) == keys and _finite(r) and r["epochs"] == 2
    assert rows[1]["mass_ratio_vs_uniform"] == 1.0 and rows[2]["mass_ratio_vs_uniform"] == 1.0
    assert rows[0]["region_weight_mass"] > 0 and set(rows[0]["val_epochs"]) <= {0, 1}
    summary = [r for r in lines if "n" in r and "method" in r]
    assert [s["method"] for s in summary[:2]] == ["method_1", "uniform"]
    assert summary[1]["mass_ratio_vs_uniform"] == "1.000 +- 0.000"
    # withhold: the startup draw, epoch 0 (withheld, release_frac 0.5 of 2), epoch 1
    assert rows[2]["release_epoch"] == 1 and len(drawn) == 3
    assert not bool((drawn[1] == planted.HARD_OBJ).any())


def test_mining_ab_main_runs(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = mining_ab.main(["--epochs", "2", "--seeds", "1", "--methods", "method_1", "uniform",
                          "--cfg", _small_cfg(tmp_path), "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    rows = [r for r in lines if "seed" in r]
    assert rows == out["rows"] and [r["method"] for r in rows] == ["method_1", "uniform"]
    for r in rows:
        assert set(r) == {"method", "seed", "epochs", "train_s", "test_joints_mepe_mm",
                          "test_corners_mepe_mm", "val_epe_dist_mm", "final_weight_spread"}
        assert _finite(r) and r["epochs"] == 2
        assert set(r["val_epe_dist_mm"]) == {"n_seen", "p10", "p50", "p90", "max", "mean"}
        d = r["val_epe_dist_mm"]
        assert d["p10"] <= d["p50"] <= d["p90"] <= d["max"]
    assert rows[1]["final_weight_spread"] == 0.0  # uniform leaves the map alone
    assert rows[0]["final_weight_spread"] > 0.0
    assert [s["method"] for s in lines if "n_runs" in s] == ["method_1", "uniform"]
