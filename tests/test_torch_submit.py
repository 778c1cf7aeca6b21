"""The port's submission path (``artiboost_torch.submit_reload``,
``submit/epoch_pass.py``, ``viztools/draw.py``) against the JAX package's.

- ``HOSubmitEpochPass``'s dump is byte-equal to JAX's on the same
  predictions (a full batch and a padded tail, fitted verts appended raw),
  and so is the zip layout.
- ``main_worker`` of both packages on the 12-sample ``SyntheticHO`` fixture
  of ``tests/test_submit_rehearsal.py`` (batch 8: one full batch and a
  padded tail of 4), the eval config's arch cut to ResNet18 at 64 x 64 with
  8 x 8 heatmaps, from the same weights (the flax initialisation JAX's
  ``main_worker`` makes, through ``hybrid_baseline_from_flax``): the
  dumped joints within 5e-5 m, equal lengths, the same zip layout. The
  port's run fits meshes (its verts finite, raw in the camera frame);
  JAX's does not, to keep the file's time: the fit is held against JAX's
  in ``tests/test_torch_postprocess.py``.
- ``render_mesh_overlay`` and ``draw_batch`` on the CPU twin of kernel B2
  against JAX's plain raster: the PNGs within one level on at least 99 %
  of the values. B2 quantises the shaded colour to 8 bits before the
  alpha blend (a step of 1/255 times alpha 0.65), which moves a blended
  value by one level where the truncation to uint8 falls between; an
  edge pixel the two rasters cover differently could differ by more.
  Measured: every value within one level, 97.8 % of the overlay's and
  99.7 % of the drawn grid's equal.
"""
import copy
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from artiboost_torch import submit_reload as t_submit
from artiboost_torch.mano.model import synthetic_mano_model as t_mano
from artiboost_torch.models.arch import build_arch
from artiboost_torch.submit.epoch_pass import SubmitEpochPass as TPass
from artiboost_torch.utils.convert import hybrid_baseline_from_flax
from artiboost_torch.utils.recorder import Recorder
from artiboost_torch.viztools import draw as t_draw
from artiboost_tpu.metrics.evaluator import build_evaluator as j_build_evaluator
from artiboost_tpu.submit.epoch_pass import SubmitEpochPass as JPass
from artiboost_tpu.utils.config import load_config
from artiboost_tpu.viztools import draw as j_draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_EVAL = os.path.join(REPO, "config_eval", "eval_ho3dv2_clasbased_artiboost.yaml")
CFG_SMOKE = os.path.join(REPO, "config", "synthetic_smoke.yaml")


class _Arg:
    exp_id = "smoke"
    resume = None
    reload = None
    submit_dataset = "hodata"
    submit_dump = True
    postprocess_fit_mesh = True
    postprocess_fit_mesh_ik = "iknet"
    postprocess_fit_mesh_use_fitted_joints = False
    postprocess_draw = False
    postprocess_draw_path = None
    n_devices = 1
    batch_size = None
    filter_unseen_obj_idxs = []


class _TorchEvaluator:
    def feed_all(self, preds, batch, losses):
        pass


def test_dump_byte_equal_on_the_same_predictions(tmp_path):
    B = 4
    rng = np.random.RandomState(0)
    joints = [rng.randn(B, 21, 3).astype(np.float32) for _ in range(2)]
    verts = [rng.randn(B, 778, 3).astype(np.float32) for _ in range(2)]
    images = np.zeros((B, 8, 8, 3), np.float32)
    tail_valid = np.array([1, 1, 1, 0], np.float32)
    calls = {"j": 0, "t": 0}

    class _Fit:
        def __init__(self, side, wrap):
            self.side, self.wrap = side, wrap

        def __call__(self, pred_joints, batch):
            i = calls[self.side]
            calls[self.side] += 1
            return {"hand_verts": self.wrap(verts[i]), "joints": self.wrap(joints[i])}

    j_batches = [{"image": images}, {"image": images, "sample_valid": tail_valid}]
    j_preds = iter(joints)
    j_pass = JPass.build("hodata", arg=_Arg(), fitting_unit=_Fit("j", np.asarray))
    j_dump = tmp_path / "j" / "pred_ho3d.json"
    j_dump.parent.mkdir()
    j_pass(0, lambda state, b, key: ({"joints_3d_abs": next(j_preds)}, {}), None, j_batches,
           j_build_evaluator([], {}), dump_path=str(j_dump))

    t_batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in j_batches]
    t_preds = iter(joints)
    t_pass = TPass.build("hodata", arg=_Arg(), fitting_unit=_Fit("t", torch.from_numpy))
    t_dump = tmp_path / "t" / "pred_ho3d.json"
    t_dump.parent.mkdir()
    t_pass(0, lambda b: ({"joints_3d_abs": torch.from_numpy(next(t_preds))}, {}), t_batches,
           _TorchEvaluator(), dump_path=str(t_dump))

    assert t_dump.read_bytes() == j_dump.read_bytes()
    xyz, vv = json.loads(t_dump.read_text())
    assert len(xyz) == len(vv) == B + 3
    np.testing.assert_allclose(np.asarray(vv[B:]), verts[1][:3], atol=1e-5)  # raw, trimmed
    with zipfile.ZipFile(t_dump.with_suffix(".zip")) as zt, \
            zipfile.ZipFile(j_dump.with_suffix(".zip")) as zj:
        assert zt.namelist() == zj.namelist() == ["pred_ho3d.json"]
        assert zt.infolist()[0].compress_type == zipfile.ZIP_DEFLATED
        assert zt.read("pred_ho3d.json") == zj.read("pred_ho3d.json")


def _fixture_config():
    """The released eval config with the rehearsal's SyntheticHO split and
    the arch cut to ResNet18 at 64 x 64, 8 x 8 heatmaps."""
    cfg = load_config(CFG_EVAL)
    smoke = load_config(CFG_SMOKE)
    cfg["DATASET"]["TEST"] = {"TYPE": "SyntheticHO", "DATA_SPLIT": "test", "AUG": False,
                              "AUG_PARAM": None, "N_SAMPLES": 12, "SEED": 11, "RAW_SIZE": 256}
    cfg["ARCH"] = dict(copy.deepcopy(smoke["ARCH"]), PRETRAINED=None)
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["TRAIN"]["BATCH_SIZE"] = 8
    return cfg


def _dump_of(root):
    exps = [d for d in os.listdir(root / "exp") if d.startswith("eval_")]
    assert len(exps) == 1, exps
    return root / "exp" / exps[0] / "pred_syntheticho.json"


def test_main_worker_matches_jax(tmp_path, monkeypatch):
    """The port evaluates the variables JAX's ``main_worker`` initialises
    when it finds no checkpoint (``create_train_state`` at PRNGKey(0)),
    captured as it makes them. The init runs under jit here: the same
    bits as ``create_train_state``'s eager init, in 4 s instead of 18."""
    from artiboost_tpu.parallel.train_state import TrainState
    from train import submit_reload as j_submit

    states = []

    def create_train_state(arch, optimizer, sample, key, mesh=None):
        variables = jax.jit(lambda k, b: arch.init(k, b, train=True))(key, sample)
        states.append(TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 opt_state=optimizer.init(variables["params"])))
        return states[-1]

    monkeypatch.setattr(j_submit, "create_train_state", create_train_state)
    cfg = _fixture_config()
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "j")
    j_arg = _Arg()
    j_arg.postprocess_fit_mesh = False
    j_measures = j_submit.main_worker(j_arg, copy.deepcopy(cfg), None)
    j_json = _dump_of(tmp_path / "j")

    # the port's SyntheticHO from the JAX run's draws (tests/test_torch_data.py)
    from test_torch_data import synthetic_ho_draws, synthetic_ho_reference

    from artiboost_torch.datasets.synthetic import SyntheticHO

    class _DrawsOnly:
        def __init__(self, **cfg):
            self._images = self._joints = self._hand_pose = self._obj_pose = None

    test_cfg = cfg["DATASET"]["TEST"]
    _, ref = synthetic_ho_reference(_DrawsOnly, jax, test_cfg, cfg["DATA_PRESET"])
    draws = synthetic_ho_draws({k: v for k, v in ref.items() if not k.startswith("ref/")})
    monkeypatch.setattr(t_submit, "build_dataset", lambda c, preset, device=None: SyntheticHO(
        DATA_PRESET=preset, device=device, draws=draws,
        **{k: v for k, v in c.items() if k != "TYPE"}))
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": states[0].params["model_list_0"],
        "batch_stats": states[0].batch_stats["model_list_0"]})
    arch = build_arch(cfg["ARCH"], cfg["DATA_PRESET"])
    arch.model_list[0].load_state_dict(hybrid_baseline_from_flax(variables))
    ckpt = tmp_path / "latest.pt"
    torch.save({"epoch": 0, "model": arch.state_dict()}, ckpt)  # the recorder's layout
    (tmp_path / "t").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    arg = t_submit.build_parser().parse_args(
        ["--cfg", CFG_EVAL, "--reload", str(ckpt), "--exp_id", "smoke", "--submit_dump",
         "--postprocess_fit_mesh"])
    out = t_submit.main_worker(arg, copy.deepcopy(cfg), device="cpu")
    t_json = _dump_of(tmp_path / "t")
    assert not (t_json.parent / "checkpoints").exists()
    assert out["weights"] == str(ckpt) and out["batches"] == 2
    assert out["pred_path"] == os.path.relpath(t_json, tmp_path / "t")

    j_xyz, j_verts = json.loads(j_json.read_text())
    t_xyz, t_verts = json.loads(t_json.read_text())
    assert len(t_xyz) == len(j_xyz) == 12 and len(t_verts) == len(j_verts) == 12
    np.testing.assert_allclose(np.asarray(t_xyz), np.asarray(j_xyz), atol=5e-5, rtol=0)
    t_verts = np.asarray(t_verts)
    assert np.isfinite(t_verts).all() and np.abs(t_verts).max() > 0
    # raw verts beside flipped joints: the wrist's z has the opposite sign
    assert np.all(np.sign(t_verts[:, :, 2].mean(1)) == -np.sign(np.asarray(t_xyz)[:, 0, 2]))
    for side in (t_json, j_json):
        with zipfile.ZipFile(side.with_suffix(".zip")) as zf:
            assert zf.namelist() == ["pred_syntheticho.json"]
            assert zf.infolist()[0].compress_type == zipfile.ZIP_DEFLATED
    for name in ("Hand3DPCKMetric", "Mean3DEPE"):
        assert set(out["measures"][name]) == set(j_measures[name])
    np.testing.assert_allclose(out["measures"]["Mean3DEPE"]["joints_3d_abs_mepe"],
                               j_measures["Mean3DEPE"]["joints_3d_abs_mepe"], atol=0.05)


def _overlay_inputs():
    rng = np.random.RandomState(3)
    mano = t_mano(device="cpu")
    verts = mano.v_template.numpy() + np.float32([0.0, 0.0, 0.45])
    corners = np.stack(np.meshgrid([-0.04, 0.04], [-0.04, 0.04], [-0.04, 0.04],
                                   indexing="ij"), -1).reshape(8, 3).astype(np.float32)
    corners = corners + np.float32([0.02, 0.03, 0.5])
    intr = np.float32([[90.0, 0.0, 32.0], [0.0, 90.0, 32.0], [0.0, 0.0, 1.0]])
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    return mano, verts, corners, intr, image


def _levels_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def test_render_mesh_overlay_against_jax():
    mano, verts, corners, intr, image = _overlay_inputs()
    box = TPass.build_mapping["hodata"].BOX_TRIS
    meshes = [(verts, mano.faces.numpy(), (0.8, 0.62, 0.52)), (corners, box, (0.35, 0.6, 0.9))]
    j_img = j_draw.render_mesh_overlay(Image.fromarray(image), meshes, intr)
    t_img = t_draw.render_mesh_overlay(Image.fromarray(image), meshes, intr, device="cpu")
    diff = _levels_apart(np.asarray(t_img), np.asarray(j_img))
    covered = (np.asarray(j_img) != image).any(-1)
    assert covered.mean() > 0.1  # the meshes cover an eighth of the tile
    assert (diff <= 1).mean() >= 0.99, ((diff > 1).sum(), diff.max())


def test_draw_batch_against_jax(tmp_path):
    mano, verts, corners, intr, image = _overlay_inputs()
    B = 2
    imgs = np.stack([image, image[::-1]]).astype(np.float32) / 255.0 - 0.5
    joints = np.stack([verts[::37][:21]] * B)
    fitted = np.stack([verts, verts + np.float32([0.01, 0.0, 0.0])])
    preds = {"joints_3d_abs": joints, "corners_3d_abs": np.stack([corners] * B)}
    batch = {"image": imgs, "cam_intr": np.stack([intr] * B)}

    class _Fit:
        mano_model = mano

    j_pass = JPass.build("hodata", DRAW_PATH=str(tmp_path / "j"))
    j_pass.draw_batch(0, {k: jnp.asarray(v) for k, v in batch.items()},
                      {k: jnp.asarray(v) for k, v in preds.items()}, fitted)
    t_pass = TPass.build("hodata", DRAW_PATH=str(tmp_path / "t"), fitting_unit=_Fit())
    t_pass.draw_batch(0, {k: torch.from_numpy(v) for k, v in batch.items()},
                      {k: torch.from_numpy(v) for k, v in preds.items()}, fitted)
    j_png = np.asarray(Image.open(tmp_path / "j" / "eval_batch_0000.png"))
    t_png = np.asarray(Image.open(tmp_path / "t" / "eval_batch_0000.png"))
    assert t_png.shape == j_png.shape == (64, 4 * 64, 3)
    diff = _levels_apart(t_png, j_png)
    assert (diff <= 1).mean() >= 0.99, ((diff > 1).sum(), diff.max())


def test_recorder_eval_only(tmp_path):
    rec = Recorder("named", {"A": 1}, root=str(tmp_path), eval_only=True, timestamp="t")
    rec.close()
    assert os.path.basename(rec.dump_path) == "eval_named_t"
    assert sorted(os.listdir(rec.dump_path)) == ["dump_cfg.yaml", "evaluations", "log.txt"]


def test_plots(tmp_path):
    mano, verts, corners, intr, image = _overlay_inputs()
    joints = verts[::37][:21]
    t_draw.plot_skeleton_3d(joints, corners, save_path=str(tmp_path / "skel.png"))
    t_draw.plot_mesh_3d(verts, mano.faces.numpy(), joints, corners,
                        save_path=str(tmp_path / "mesh.png"))
    img = Image.fromarray(image)
    t_draw.draw_mesh_wireframe(img, verts, mano.faces.numpy(), intr, max_edges=200)
    j_img = j_draw.draw_mesh_wireframe(Image.fromarray(image), verts, mano.faces.numpy(), intr,
                                       max_edges=200)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(j_img))
    assert (tmp_path / "skel.png").stat().st_size > 0 and (tmp_path / "mesh.png").stat().st_size > 0


def test_entry_point_refuses_cpu_fallback(monkeypatch, tmp_path):
    from artiboost_torch.postprocess.fitting import FittingUnit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_submit.main(["--cfg", CFG_EVAL, "--submit_dump"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FittingUnit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_draw.render_mesh_overlay(Image.new("RGB", (8, 8)), [], np.eye(3))
    assert not (tmp_path / "exp").exists()
