"""The Reg, HoNet and DexYCB-recipe losses of the port against the JAX
package on the CPU: ManoLoss and ObjLoss (``criterions/honetloss.py``; the
object term through the model's vertices and through the box pose, with
and without PADDING_MASK and KEY_VALID masks), SymCornerLoss on identity
symmetries, on an absent MODEL_INFO_PATH and on discrete and continuous
``model_info`` dicts written here, in both USE_HO3D_YCB settings, AlignLoss
and ChamferLoss; and the port's own ``utils/bop_sym.py`` tables.

Each batch is made from a seed with numpy and fed to both packages'
``build_criterion`` (a masked batch through each package's
``union_concat``). Tolerances: every named loss at rtol 1e-5 (float32 sums
in another order; AlignLoss's SVD and the continuous symmetries' float32
Rodrigues are each within it); the symmetry tables at atol 1e-6 with equal
valid masks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.criterions import build_criterion as t_build
from artiboost_torch.utils.batching import union_concat as t_union
from artiboost_tpu.criterions import build_criterion as j_build
from artiboost_tpu.utils.batching import union_concat as j_union

B_REAL, B_SYNTH, V = 3, 5, 60
ABSENT_INFO = "./assets/extend_models_info.json"  # named by the released configs


def _rotations(rng, n):
    """(n, 3, 3) float32 rotations from random axis-angles (float64 Rodrigues)."""
    aa = rng.randn(n, 3) * 0.8
    theta = np.linalg.norm(aa, axis=1)[:, None, None]
    k = aa / np.linalg.norm(aa, axis=1, keepdims=True)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return (np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K).astype(np.float32)


def model_info():
    """Four objects: none, a discrete 180-degree flip about z, a continuous
    z axis, and a discrete flip about x with a continuous y axis whose
    offset (mm) is not zero."""
    flip_z = np.diag([-1.0, -1.0, 1.0, 1.0])
    flip_x = np.diag([1.0, -1.0, -1.0, 1.0])
    flip_x[:3, 3] = [0.0, 4.0, -2.0]
    return {"1": {},
            "2": {"symmetries_discrete": [flip_z.reshape(-1).tolist()], "diameter": 150.0},
            "3": {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                  "diameter": 120.0},
            "4": {"symmetries_discrete": [flip_x.reshape(-1).tolist()],
                  "symmetries_continuous": [{"axis": [0, 1, 0], "offset": [1.0, 0, 3.0]}],
                  "diameter": 200.0}}


def batch(seed, padded=True, masked=False, pred_verts=False, n_obj=4):
    """-> (preds, JAX batch, torch batch). The targets are a real half of
    B_REAL and a synth half of B_SYNTH samples; when ``masked`` the real
    half lacks the object pose, the object and hand vertices and the
    joints, so ``union_concat`` masks them."""
    rng = np.random.RandomState(seed)
    B = B_REAL + B_SYNTH

    def half(n):
        rot = _rotations(rng, n)
        transf = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        transf[:, :3, :3] = rot
        transf[:, :3, 3] = rng.randn(n, 3) * 0.05 + [0, 0, 0.5]
        corners_can = (rng.randn(n, 8, 3) * 0.05).astype(np.float32)
        verts_can = (rng.randn(n, V, 3) * 0.05).astype(np.float32)
        root = (rng.randn(n, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32)
        part = {
            "joints_3d": (rng.randn(n, 21, 3) * 0.05).astype(np.float32),
            "root_joint": root,
            "corners_can": corners_can,
            "corners_vis": (rng.rand(n, 8) > 0.2).astype(np.float32),
            "obj_transf": transf,
            "obj_idx": rng.randint(1, n_obj + 1, size=(n,)).astype(np.int32),
            "obj_verts_can": verts_can,
            "obj_verts_3d": (verts_can @ rot.transpose(0, 2, 1) + transf[:, None, :3, 3]
                             - root[:, None]).astype(np.float32),
            "hand_verts_3d": (rng.randn(n, 778, 3) * 0.05).astype(np.float32),
        }
        if padded:
            part["padding_mask"] = (rng.rand(n, V) > 0.25).astype(np.float32)
        return part

    real, synth = half(B_REAL), half(B_SYNTH)
    if masked:
        for k in ("obj_transf", "obj_verts_3d", "hand_verts_3d", "joints_3d"):
            del real[k]
    root = np.concatenate([real["root_joint"], synth["root_joint"]])
    preds = {
        "joints_3d_abs": (rng.randn(B, 21, 3) * 0.05 + root[:, None]).astype(np.float32),
        "hand_verts_3d_abs": (rng.randn(B, 778, 3) * 0.05 + root[:, None]).astype(np.float32),
        "corners_3d_abs": (rng.randn(B, 8, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
        "box_rot_rotmat": _rotations(rng, B),
        "boxroot_3d_abs": (rng.randn(B, 1, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
        "mano_shape": rng.randn(B, 10).astype(np.float32),
        "mano_pca_pose": rng.randn(B, 18).astype(np.float32),
    }
    if pred_verts:
        preds["obj_verts_3d_abs"] = (rng.randn(B, V, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    jb = j_union([{k: jnp.asarray(v) for k, v in p.items()} for p in (real, synth)])
    tb = t_union([{k: torch.from_numpy(v) for k, v in p.items()} for p in (real, synth)])
    assert ("_key_valid" in tb) == masked
    return preds, jb, tb


def hold(cfg, preds, jb, tb):
    """Both packages' criterions on the same inputs -> the port's losses,
    after holding every named loss at rtol 1e-5."""
    _, jl = j_build(cfg).compute_losses({k: jnp.asarray(v) for k, v in preds.items()}, jb, None)
    crit = t_build(cfg)
    _, tl = crit.compute_losses({k: torch.from_numpy(v) for k, v in preds.items()}, tb,
                                [{} for _ in crit.loss_list])
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=0, err_msg=k)
    return tl


HONET_CFG = {"LAMBDAS": [1.0, 0.5], "CRITERION": [
    {"TYPE": "ManoLoss", "LAMBDA_JOINTS_3D": 0.5, "LAMBDA_HAND_VERTS_3D": 0.7,
     "LAMBDA_SHAPE_REG": 5e-7, "LAMBDA_POSE_REG": 5e-6},
    {"TYPE": "ObjLoss", "LAMBDA_OBJ_VERTS_3D": 1.0}]}


@pytest.mark.parametrize("pred_verts", [False, True])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mano_and_obj_losses(masked, padded, pred_verts):
    """ManoLoss's four terms and ObjLoss's three branches: the mask of
    PADDING_MASK times KEY_VALID (or either alone, or none), and the
    prediction from ``obj_verts_3d_abs`` or from the box pose."""
    tl = hold(HONET_CFG, *batch(10, padded=padded, masked=masked, pred_verts=pred_verts))
    assert {"mano_shape", "mano_pca_pose", "joints_3d_loss", "hand_verts_3d_loss",
            "obj_verts_3d_loss"} <= set(tl)
    assert all(float(v) > 0 for v in tl.values())


def test_obj_loss_without_object_vertices():
    """Without OBJ_VERTS_3D in the targets ObjLoss adds nothing."""
    preds, jb, tb = batch(11)
    del jb["obj_verts_3d"], tb["obj_verts_3d"]
    tl = hold(HONET_CFG, preds, jb, tb)
    assert "obj_verts_3d_loss" not in tl and float(tl["obj_loss_output"]) == 0.0


def _sym_cfg(info, ho3d):
    return {"LAMBDAS": [1.0], "CRITERION": [
        {"TYPE": "SymCornerLoss", "LAMBDA_SYM_CORNERS_3D": 1.0, "USE_HO3D_YCB": ho3d,
         **({} if info is None else {"MODEL_INFO_PATH": info})}]}


@pytest.mark.parametrize("ho3d", [False, True])
@pytest.mark.parametrize("info", ["identity", "absent", "dict"])
def test_sym_corner_loss(info, ho3d, caplog):
    """Identity symmetries (no MODEL_INFO_PATH, 21 objects), the released
    configs' absent path (identity, with a warning in the port, as JAX
    degrades silently) and the four-object dict, in both frames."""
    n_obj = 4 if info == "dict" else 21
    model = {"identity": None, "absent": ABSENT_INFO, "dict": model_info()}[info]
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        tl = hold(_sym_cfg(model, ho3d), *batch(20, n_obj=n_obj))
    assert float(tl["sym_corners_3d_loss"]) > 0
    warned = [r.message for r in caplog.records if "MODEL_INFO_PATH" in r.message]
    assert warned == ([f"MODEL_INFO_PATH {ABSENT_INFO} is absent; the object symmetries are "
                       "identity, as in the JAX package"] if info == "absent" else [])


def test_sym_corner_loss_masked():
    """A real half without the object pose: its rows drop out of the mean."""
    hold(_sym_cfg(model_info(), False), *batch(21, masked=True))


@pytest.mark.parametrize("ho3d", [False, True])
def test_sym_corner_loss_takes_the_least_symmetry(ho3d):
    """Object 2's 180-degree flip: a prediction at the flipped ground-truth
    corners costs nothing, in either frame, on both sides."""
    preds, jb, tb = batch(22, n_obj=4)
    for b in (jb, tb):
        b["obj_idx"] = b["obj_idx"] * 0 + 2
    corners, transf = np.asarray(jb["corners_can"]), np.asarray(jb["obj_transf"])
    flip = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    if ho3d:
        ext = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        flip = ext @ flip @ ext
    sym = corners @ flip.T
    preds["corners_3d_abs"] = (np.einsum("bij,bnj->bni", transf[:, :3, :3], sym)
                               + transf[:, None, :3, 3]).astype(np.float32)
    tl = hold(_sym_cfg(model_info(), ho3d), preds, jb, tb)
    assert float(tl["sym_corners_3d_loss"]) < 1e-10


def test_bop_sym_tables_against_jax():
    from artiboost_torch.utils import bop_sym as t_sym
    from artiboost_tpu.utils import bop_sym as j_sym

    for info in (model_info(), None):
        want = j_sym.build_sym_tensor(info or j_sym.default_ycb_model_info())
        got = t_sym.build_sym_tensor(info)
        assert [g.shape for g in got] == [w.shape for w in want]
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[2], want[2])
    R, _, valid = t_sym.build_sym_tensor(model_info())
    assert valid.sum(1).tolist() == [1, 2, 314, 628] and R.shape[1] == 628


@pytest.mark.parametrize("masked", [False, True])
def test_align_loss(masked):
    """Procrustes-aligned joint MSE; a masked real half aligns to the
    detached prediction and drops out."""
    cfg = {"LAMBDAS": [1.0], "CRITERION": [{"TYPE": "AlignLoss", "LAMBDA_PROCRUSTES_ALIGN": 1.0}]}
    tl = hold(cfg, *batch(30, masked=masked))
    assert float(tl["procrustes_aligned_loss"]) > 0


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_loss(masked, padded):
    """Both directions of the chamfer distance between the box-posed and the
    ground-truth object vertices, PADDING_MASK on both clouds."""
    cfg = {"LAMBDAS": [1.0], "CRITERION": [{"TYPE": "ChamferLoss", "LAMBDA_CHAMFER": 1.0}]}
    tl = hold(cfg, *batch(40, padded=padded, masked=masked))
    assert float(tl["chamfer_loss"]) > 0
