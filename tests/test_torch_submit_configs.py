"""``submit_reload`` on the four released evaluation configs beside
``eval_ho3dv2_clasbased_artiboost.yaml`` (which ``tests/test_torch_submit.py``
holds), on files in the official layouts: HO3D v2's and v3's evaluation
splits (``artiboost_torch/datasets/layouts.py``, 12 frames at 640 x 480 over
two sequences) and, in ``tests/test_torch_submit_dexycb.py``, a DexYCB s0
test split (``layouts.write_dexycb``; its loader is held against JAX on
such files in ``tests/test_torch_dexycb.py``). Each config's arch is cut as
``tests/test_torch_submit.py`` cuts it: ResNet18 at 64 x 64 with 8 x 8
heatmaps (the Reg config keeps ``synthetic_smoke_reg.yaml``'s ManoBranch),
batch 8, so one full batch and a tail padded from 4 (HO3D) or 2 (DexYCB).

- ``eval_ho3dv2_regbased`` (HOPRegNet) here and ``eval_dexycb_clasbased_sym``
  (HybridBaseline, ``SymCornerLoss``, BOP's AR) there against JAX's
  ``train/submit_reload.py`` ``main_worker`` from the same weights (the
  flax initialisation JAX makes, through ``utils/convert.py``'s
  ``FROM_FLAX``): the dumped joints within 5e-5 m (``test_torch_submit.py``'s
  bound; the two image paths differ within 1e-4, ROADMAP C), the same
  number of rows and the same zip layout; DexYCB's AR measures within
  rtol 1e-5 (``tests/test_torch_metrics_ar.py``'s bound; the recalls, being
  counts, equal).
- ``eval_ho3dv3_clasbased`` and ``eval_ho3dv3_clasbased_sym`` through the
  port alone (HO3D v3's loader is held against JAX in
  ``tests/test_torch_ho3d.py``): their ``pred_ho3dv3.json`` has a row of 21
  joints and one of 778 verts a frame, the zip its one member, and AR
  finite recalls in [0, 1].
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
import yaml

from artiboost_torch import submit_reload as t_submit
from artiboost_torch.datasets import layouts
from artiboost_torch.models.arch import build_arch
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import FROM_FLAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJS = ["003_cracker_box", "006_mustard_bottle"]


class _Arg:
    exp_id = "cfgs"
    resume = None
    reload = None
    submit_dataset = "hodata"
    submit_dump = True
    postprocess_fit_mesh = False
    postprocess_fit_mesh_ik = "iknet"
    postprocess_fit_mesh_use_fitted_joints = False
    postprocess_draw = False
    postprocess_draw_path = None
    n_devices = 1
    batch_size = None
    filter_unseen_obj_idxs = []


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """HO3D v2's and v3's evaluation splits and the YCB meshes."""
    root = tmp_path_factory.mktemp("submit_cfgs")
    rng = np.random.RandomState(3)
    data = str(root / "data")
    for version in ("v2", "v3"):
        layouts.write_ho3d(data, "test", {"SM1": 6, "MPM10": 6}, OBJS, rng, version=version)
    layouts.write_ycb_models(os.path.join(data, "YCB_models_process"), OBJS, rng, n_lat=8,
                             n_lon=12, tex_size=16)
    return root


def write_dexycb(root):
    """A DexYCB s0 test split under ``root``/data (``layouts.write_dexycb``):
    3 subjects of 5 scenes, a frame a camera but 5 in the third subject's
    fifth scene, which s0 tests: 10 frames."""
    layouts.write_dexycb(os.path.join(str(root), "data"), 3, 5, 1, np.random.RandomState(4),
                         test_frames=5)


def _config(name: str, data_root) -> dict:
    cfg = load_config(os.path.join(REPO, "config_eval", f"{name}.yaml"))
    smoke = "synthetic_smoke_reg" if "regbased" in name else "synthetic_smoke"
    cfg["ARCH"] = dict(copy.deepcopy(load_config(os.path.join(REPO, "config",
                                                               f"{smoke}.yaml"))["ARCH"]),
                       PRETRAINED=None)
    cfg["DATASET"]["TEST"]["DATA_ROOT"] = str(data_root / "data")
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["TRAIN"]["BATCH_SIZE"] = 8
    return cfg


def _run_port(name, cfg, workdir, reload=None):
    workdir.mkdir()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        (workdir / "eval.yaml").write_text(yaml.safe_dump(cfg))
        argv = ["--cfg", "eval.yaml", "--exp_id", "cfgs", "--submit_dump", "--device", "cpu"]
        out = t_submit.main(argv + (["--reload", str(reload)] if reload else []))
    finally:
        os.chdir(cwd)
    return out, workdir / out["pred_path"]


def _dump(path):
    with open(path) as f:
        xyz, verts = json.load(f)
    with zipfile.ZipFile(str(path).replace(".json", ".zip")) as zf:
        infos = zf.infolist()
        assert [i.filename for i in infos] == [os.path.basename(path)]
        assert infos[0].compress_type == zipfile.ZIP_DEFLATED
        assert zf.read(infos[0].filename) == open(path, "rb").read()
    return np.asarray(xyz), verts


def against_jax(name, data, tmp_path, monkeypatch):
    """JAX's ``main_worker`` and the port's ``submit_reload`` on ``name`` from
    the same weights; the dumps and measures held as the docstring says."""
    from artiboost_tpu.parallel.train_state import TrainState
    from train import submit_reload as j_submit

    states = []

    def create_train_state(arch, optimizer, sample, key, mesh=None):
        """JAX's initialisation, under jit (the same bits as the eager init)."""
        variables = jax.jit(lambda k, b: arch.init(k, b, train=True))(key, sample)
        states.append(TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                 batch_stats=variables.get("batch_stats", {}),
                                 opt_state=optimizer.init(variables["params"])))
        return states[-1]

    monkeypatch.setattr(j_submit, "create_train_state", create_train_state)
    cfg = _config(name, data)
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "j")
    j_measures = j_submit.main_worker(_Arg(), copy.deepcopy(cfg), None)
    kind = cfg["DATASET"]["TEST"]["TYPE"].lower()
    exps = [d for d in os.listdir("exp") if d.startswith("eval_")]
    j_xyz, j_verts = _dump(tmp_path / "j" / "exp" / exps[0] / f"pred_{kind}.json")

    variables = jax.tree_util.tree_map(np.asarray, {
        "params": states[0].params["model_list_0"],
        "batch_stats": states[0].batch_stats.get("model_list_0", {})})
    arch = build_arch(cfg["ARCH"], cfg["DATA_PRESET"])
    arch.model_list[0].load_state_dict(FROM_FLAX[cfg["ARCH"]["TYPE"]](variables))
    ckpt = tmp_path / "latest.pt"
    torch.save({"epoch": 0, "model": arch.state_dict()}, ckpt)
    out, t_path = _run_port(name, cfg, tmp_path / "t", reload=ckpt)
    assert out["weights"] == str(ckpt) and out["batches"] == 2
    assert t_path.name == f"pred_{kind}.json"
    t_xyz, t_verts = _dump(t_path)
    n = 12 if kind == "ho3d" else 10
    assert t_xyz.shape == j_xyz.shape == (n, 21, 3) and len(t_verts) == len(j_verts) == n
    np.testing.assert_allclose(t_xyz, j_xyz, atol=5e-5, rtol=0)
    if kind == "dexycb":
        t_ar, j_ar = out["measures"]["AR"], j_measures["AR"]
        assert set(t_ar) == set(j_ar) and "AR_MSSD" in t_ar
        for k in j_ar:
            if k.startswith("AR"):
                assert t_ar[k] == j_ar[k], k
            else:
                np.testing.assert_allclose(t_ar[k], j_ar[k], rtol=1e-5, err_msg=k)
    else:  # HOPRegNet: the MANO terms are measured
        assert {"mano_shape", "mano_pca_pose"} <= set(out["measures"]["LossesMetric"])
    for metric in ("Mean3DEPE", "Hand3DPCKMetric"):
        assert set(out["measures"][metric]) == set(j_measures[metric])


def test_regbased_against_jax(data, tmp_path, monkeypatch):
    against_jax("eval_ho3dv2_regbased_artiboost", data, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", ["eval_ho3dv3_clasbased_artiboost",
                                  "eval_ho3dv3_clasbased_sym_artiboost"])
def test_ho3dv3_through_the_port(name, data, tmp_path):
    out, path = _run_port(name, _config(name, data), tmp_path / "t")
    assert out["batches"] == 2 and path.name == "pred_ho3dv3.json"
    xyz, verts = _dump(path)
    assert xyz.shape == (12, 21, 3) and np.isfinite(xyz).all()
    assert len(verts) == 12 and all(np.asarray(v).shape == (778, 3) for v in verts)
    ar = out["measures"]["AR"]
    assert all(np.isfinite(v) for v in ar.values())
    assert all(0.0 <= v <= 1.0 for k, v in ar.items() if k.startswith("AR"))
