"""The visualizer and the checkpoint-parity harness on the CPU
(``artiboost_torch/scripts/viz_artiboost_render.py``, ``eval_parity.py``).

- ``viz_artiboost_render`` renders a synth batch of
  ``config/synthetic_smoke.yaml`` through the CPU twin of kernel B1 (of B2
  with ``--flat``) and writes one PNG a sample and the two grids; the mesh
  grid's overlays (through B2's twin) change the images where the meshes
  fall, and the plain tiles equal the batch's images but for the drawn
  skeleton and corners.
- ``eval_parity`` reads a ``.pth.tar`` in the reference's layout
  (``state_dict`` with ``module.`` names) that the test writes from a port
  model trained one step on a SyntheticHO fixture; its Mean3DEPE row equals
  the TEST pass's (``train.test_epoch``) on the same weights and batches,
  bit for bit. A checkpoint that does not exist stops it.
"""
import copy
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from artiboost_torch import train
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.ops import rasterizer_cuda
from artiboost_torch.scripts import eval_parity, viz_artiboost_render
from artiboost_torch.utils.config import load_config

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
                     "synthetic_smoke.yaml")


def _twin_calls(monkeypatch):
    """Counts the raster wrappers' calls (on the CPU each runs its twin)."""
    calls = {"raster_uv": 0, "raster_rgb": 0}
    for name in calls:
        fn = getattr(rasterizer_cuda, name)

        def counted(inp, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(inp)
        monkeypatch.setattr(rasterizer_cuda, name, counted)
    return calls


@pytest.mark.parametrize("flat", [False, True], ids=["textured", "flat"])
def test_viz_writes_its_pngs(flat, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = _twin_calls(monkeypatch)
    argv = ["--cfg", SMOKE,
            "--n_samples", "4", "--out", str(tmp_path / "viz"), "--device", "cpu"]
    out = viz_artiboost_render.main(argv + (["--flat"] if flat else []))
    names = sorted(p.split("/")[-1] for p in out["pngs"])
    assert names == ["synth_000.png", "synth_001.png", "synth_002.png", "synth_003.png",
                     "synth_grid.png", "synth_mesh_grid.png"]
    # the render went through B1's twin (B2's with --flat); each overlay through B2's
    assert calls == ({"raster_uv": 0, "raster_rgb": 1 + 4} if flat
                     else {"raster_uv": 1, "raster_rgb": 4}), calls
    imgs = ((out["batch"]["image"].float().numpy() + 0.5) * 255).clip(0, 255).astype(np.uint8)
    tile = np.asarray(Image.open(tmp_path / "viz" / "synth_000.png"))
    assert tile.shape == imgs[0].shape and (tile != imgs[0]).any(-1).mean() < 0.2
    grid = np.asarray(Image.open(tmp_path / "viz" / "synth_grid.png"))
    mesh = np.asarray(Image.open(tmp_path / "viz" / "synth_mesh_grid.png"))
    assert grid.shape == mesh.shape == (2 * 128, 2 * 128, 3)
    assert 0.02 < (grid != mesh).any(-1).mean() < 0.9  # the meshes cover part of each tile


def _fixture_config(tmp_path):
    """synthetic_smoke.yaml at batch 4 and 64 x 64: CONFIG_LEN_TRAIN 4 and
    no train split (one synth step), a SyntheticHO TEST split of 12."""
    cfg = load_config(SMOKE)
    del cfg["DATASET"]["TRAIN"]
    cfg["DATASET"]["TEST"].update(N_SAMPLES=12, RAW_SIZE=64)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=4, VAL_LEN=4)
    cfg["MANAGER"]["RENDERER"].update(RENDER_SIZE=[128, 128],
                                      CAM_PARAM={"FX": 218.0, "FY": 218.0, "CX": 64.0,
                                                 "CY": 64.0})
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["ARCH"]["HYBRID_HEAD"].update(NUM_DECONV_FILTERS=[32, 32], DEPTH_RESOLUTION=8)
    cfg["TRAIN"]["BATCH_SIZE"] = 4
    path = tmp_path / "fixture.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_eval_parity_reads_a_released_layout_checkpoint(tmp_path, monkeypatch):
    cfg, cfg_path = _fixture_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    trained = train.run(copy.deepcopy(cfg), epochs=1, device="cpu", test_freq=0)
    assert trained["step"].step == 1  # one optimizer step
    arch = trained["model"]
    ckpt = tmp_path / "fixture_1step.pth.tar"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in
                                           arch.model_list[0].state_dict().items()}}, ckpt)

    want_eval = build_evaluator(
        [m for m in cfg["EVALUATOR"] if not m["TYPE"].startswith("ValMetric")],
        cfg["DATA_PRESET"], device="cpu")
    test_data = build_dataset(cfg["DATASET"]["TEST"], cfg["DATA_PRESET"], device="cpu")
    with torch.no_grad():
        res = train.test_epoch(test_data, 8, arch, trained["step"].criterion, want_eval,
                               trained["loader"].draws, train.StageTimer(torch.device("cpu")))
    assert res["batches"] == 2  # a batch of 8 and a tail of 4 padded to 8
    want = want_eval.get_measures_all_striped()["Mean3DEPE"]

    got = eval_parity.main(["--cfg", cfg_path, "--ckpt", str(ckpt), "--batch_size", "8",
                            "--device", "cpu", "--expected_mpcpe", "100"])
    assert got["batches"] == 2
    for k, v in want.items():
        assert got["row"][k] == round(float(v), 3), k
    assert got["mpcpe"] == pytest.approx(want["corners_3d_abs_mepe"], rel=1e-6)
    with pytest.raises(SystemExit, match="did not load"):
        eval_parity.main(["--cfg", cfg_path, "--ckpt", str(tmp_path / "absent.pth.tar"),
                          "--device", "cpu"])
