"""Real-data batches of the port through the vertex losses and metrics, on
the HO3D fixture of ``tests/test_real_batch_losses.py`` (an off-centre YCB
mesh on disk, MANO fits in the metas, corners consistent with (R, t)),
against the JAX package: the canonical frame of OBJ_TRANSF, the batch's
vertices and MANO keys exactly (image aside, held in
tests/test_torch_ho3d.py), and ManoLoss, ChamferLoss and ValMetricAR2's
vertex MSSD on the batch and on perturbed predictions at rtol 1e-5 (atol
1e-7 about zero), the tolerance of tests/test_torch_criterions_reg.py.

A mixed batch whose real and synth halves disagree on the vertex count
(HO3D's YCB meshes against the object library's ``V_MAX``; the JAX
package's union raises there, ROADMAP C): ``union_concat`` gives what
``ho_collate`` gives for the samples joined, and ObjLoss and the vertex
MSSD, which read PADDING_MASK, give each sample's unpadded value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.criterions.chamferloss import ChamferLoss as TChamfer
from artiboost_torch.criterions.honetloss import ManoLoss as TMano
from artiboost_torch.criterions.honetloss import ObjLoss
from artiboost_torch.datasets.ho3d import HO3D as THO3D
from artiboost_torch.datasets.hodata import ho_collate
from artiboost_torch.datasets.hoquery import Queries, SynthQueries
from artiboost_torch.metrics.val_metric import mssd_values
from artiboost_torch.metrics.val_metric import ValMetricAR2 as TAR2
from artiboost_torch.utils.batching import union_concat
from artiboost_tpu.criterions.chamferloss import ChamferLoss as JChamfer
from artiboost_tpu.criterions.honetloss import ManoLoss as JMano
from artiboost_tpu.datasets.ho3d import HO3D as JHO3D
from artiboost_tpu.metrics.val_metric import ValMetricAR2 as JAR2
from tests.test_real_batch_losses import PRESET, ho3d_root  # noqa: F401  (fixture)

TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture
def pair(ho3d_root, monkeypatch):  # noqa: F811
    monkeypatch.chdir(ho3d_root)
    cfg = dict(DATA_PRESET=PRESET, DATA_SPLIT="train", DATA_ROOT=ho3d_root,
               SPLIT_MODE="paper", AUG=False, AUG_PARAM=None)
    return JHO3D(**cfg), THO3D(device="cpu", **cfg)


def _batches(pair):
    jds, tds = pair
    return jds.sample_batch([0, 1, 2]), tds.sample_batch([0, 1, 2])


def test_obj_transf_frame(pair):
    jds, tds = pair
    for i in range(len(tds)):
        for name in ("get_obj_transf", "get_corners_can", "get_obj_verts_can"):
            np.testing.assert_array_equal(getattr(tds, name)(i), getattr(jds, name)(i))
        transf = tds.get_obj_transf(i)
        got = tds.get_corners_can(i) @ transf[:3, :3].T + transf[:3, 3]
        np.testing.assert_allclose(got, tds.get_corners_3d(i), atol=1e-5)


def test_batch_carries_verts_and_mano(pair):
    want, got = _batches(pair)
    assert set(got) == set(want)
    assert got[Queries.OBJ_VERTS_3D].shape == (3, 6, 3)
    assert got[Queries.HAND_VERTS_3D].shape == (3, 778, 3)
    for k, v in want.items():
        if k != Queries.IMAGE:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def _preds(batch, shift, lib):
    """Ground-truth predictions moved by ``shift`` (m), in either package."""
    root = batch[Queries.ROOT_JOINT][:, None]
    transf = batch[Queries.OBJ_TRANSF]
    return {"joints_3d_abs": batch[Queries.JOINTS_3D] + root,
            "hand_verts_3d_abs": batch[Queries.HAND_VERTS_3D] + root + shift,
            "box_rot_rotmat": transf[:, :3, :3],
            "boxroot_3d_abs": transf[:, :3, 3] + shift}


@pytest.mark.parametrize("shift", [0.0, 0.02])
def test_losses_and_mssd(pair, shift):
    want, got = _batches(pair)
    jb = {k: jnp.asarray(v) for k, v in want.items()}
    for tcls, jcls, kw in ((TMano, JMano, dict(LAMBDA_JOINTS_3D=1.0, LAMBDA_HAND_VERTS_3D=1.0)),
                           (TChamfer, JChamfer, dict(LAMBDA_CHAMFER=1.0))):
        t_loss, t_terms = tcls(**kw)(_preds(got, shift, torch), got)
        j_loss, j_terms = jcls(**kw)(_preds(jb, shift, jnp), jb)
        np.testing.assert_allclose(float(t_loss), float(j_loss), **TOL)
        for k, v in j_terms.items():
            if v is not None:
                np.testing.assert_allclose(float(t_terms[k]), float(v), **TOL, err_msg=k)
        assert (float(t_loss) > 1e-5) == (shift > 0)
    ids = {SynthQueries.IS_SYNTH: np.ones(3, np.int32), SynthQueries.OBJ_ID: np.zeros(3, np.int32),
           SynthQueries.PERSP_ID: np.arange(3, dtype=np.int32),
           SynthQueries.GRASP_ID: np.zeros(3, np.int32)}
    cfg = dict(USE_MSSD=True, MSSD_USE_CORNERS=False, USE_HO3D_YCB=True, CCV_SHAPE=(2, 4, 4))
    tm, jm = TAR2(device="cpu", **cfg), JAR2(**cfg)
    tm.feed(_preds(got, shift, torch), dict(got, **{k: torch.from_numpy(v) for k, v in ids.items()}))
    jm.feed(_preds(jb, shift, jnp), dict(jb, **{k: jnp.asarray(v) for k, v in ids.items()}))
    (tmap, tseen), (jmap, jseen) = tm.get_averaged_maps(), jm.get_averaged_maps()
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    np.testing.assert_allclose(tmap.numpy()[tseen.numpy()], np.asarray(jmap)[np.asarray(jseen)],
                               rtol=1e-5, atol=1e-6)


_VERTS = (Queries.OBJ_VERTS_CAN, Queries.OBJ_VERTS_3D, Queries.OBJ_VERTS_2D)


def _vertex_samples(counts, rng):
    """Samples with ``counts`` object vertices each, a random pose (R, t)
    and root: (sample dicts, their (R, t))."""
    samples, poses = [], []
    for v in counts:
        rot = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
        tsl = rng.randn(3).astype(np.float32)
        root = rng.randn(3).astype(np.float32)
        can = rng.randn(v, 3).astype(np.float32) * 0.05
        verts = can @ rot.T + tsl
        samples.append({Queries.OBJ_VERTS_CAN: can, Queries.OBJ_VERTS_3D: verts - root,
                        Queries.OBJ_VERTS_2D: verts[:, :2] / verts[:, 2:],
                        Queries.ROOT_JOINT: root})
        poses.append((rot, tsl))
    return samples, poses


def _library_part(samples, v_max):
    """The synth half's layout: vertices zero-filled to the library's
    ``V_MAX``, PADDING_MASK a prefix of ones (``synth_batch.py``)."""
    out = {}
    for k in _VERTS:
        a = np.zeros((len(samples), v_max, samples[0][k].shape[1]), np.float32)
        for i, s in enumerate(samples):
            a[i, :len(s[k])] = s[k]
        out[k] = torch.from_numpy(a)
    mask = np.zeros((len(samples), v_max), np.float32)
    for i, s in enumerate(samples):
        mask[i, :len(s[Queries.OBJ_VERTS_CAN])] = 1.0
    out[Queries.PADDING_MASK] = torch.from_numpy(mask)
    out[Queries.ROOT_JOINT] = torch.from_numpy(np.stack([s[Queries.ROOT_JOINT] for s in samples]))
    return out


def _copy(samples):
    return [{k: v.copy() for k, v in s.items()} for s in samples]


@pytest.mark.parametrize("real_counts, synth_counts, v_max",
                         [((5, 7, 3), (12, 9), 12),   # the real half padded
                          ((12, 9, 11), (5, 7), 8)])  # the synth half padded
def test_union_pads_unequal_vertex_counts(real_counts, synth_counts, v_max):
    rng = np.random.RandomState(3)
    real, real_pose = _vertex_samples(real_counts, rng)
    synth, synth_pose = _vertex_samples(synth_counts, rng)
    got = union_concat([ho_collate(_copy(real), "cpu"), _library_part(synth, v_max)])
    want = ho_collate(_copy(real + synth), "cpu")
    assert set(got) == set(want)
    n = len(real)
    np.testing.assert_array_equal(got[Queries.PADDING_MASK].numpy(),
                                  want[Queries.PADDING_MASK].numpy())
    valid = want[Queries.PADDING_MASK].numpy() > 0
    for k in _VERTS + (Queries.ROOT_JOINT,):
        g, w = got[k].numpy(), want[k].numpy()
        assert g.shape == w.shape, k
        # the real rows and every re-padded row exactly; an untouched
        # library row keeps its zeros beyond its mask
        exact = n if v_max >= max(real_counts) else len(g)
        np.testing.assert_array_equal(g[:exact], w[:exact], err_msg=k)
        if g.ndim == 3:
            np.testing.assert_array_equal(g[valid], w[valid], err_msg=k)

    # predictions off the truth; every loss below reads PADDING_MASK
    poses = real_pose + synth_pose
    rot = torch.from_numpy(np.stack([np.linalg.qr(rng.randn(3, 3))[0] @ r for r, _ in poses]
                                    ).astype(np.float32))
    tsl = torch.from_numpy(np.stack([t + rng.randn(3) * 0.01 for _, t in poses]
                                    ).astype(np.float32))
    preds = {"joints_3d_abs": torch.zeros((len(poses), 21, 3)), "box_rot_rotmat": rot,
             "boxroot_3d_abs": tsl}
    loss, _ = ObjLoss(LAMBDA_OBJ_VERTS_3D=1.0)(preds, got)
    num = den = 0.0
    mssd = []
    for i, s in enumerate(real + synth):
        pred = s[Queries.OBJ_VERTS_CAN].astype(np.float64) @ rot[i].numpy().T.astype(np.float64) \
            + tsl[i].numpy()
        targ = s[Queries.OBJ_VERTS_3D].astype(np.float64) + s[Queries.ROOT_JOINT]
        num += ((pred - targ) ** 2).sum()
        den += 3.0 * len(pred)
        mssd.append(np.linalg.norm(pred - targ, axis=1).max())
    np.testing.assert_allclose(float(loss), num / den, **TOL)
    b = len(poses)
    vals = mssd_values(rot, tsl[:, None], got[Queries.OBJ_VERTS_CAN], got[Queries.PADDING_MASK],
                       torch.from_numpy(np.stack([np.block([[r, t[:, None]], [np.zeros((1, 3)),
                                                            np.ones((1, 1))]])
                                                  for r, t in poses]).astype(np.float32)),
                       torch.eye(3).expand(b, 1, 3, 3), torch.zeros((b, 1, 3)), torch.ones((b, 1)))
    np.testing.assert_allclose(vals.numpy(), mssd, **TOL)
