"""The BOP metrics of the port against the JAX package on the CPU:
``mssd_values``, ``mspd_values`` and ``vsd_values``; ``ValMetricAR2``'s
per-triplet maps; the test metric ``AR``'s measures after several feeds
(a padded TEST tail, a batch without PADDING_MASK, a batch of another
size); the evaluator built from the DexYCB recipe; and ``step_eval`` with
both ValMetrics, whose new weight map is held against the JAX loader's
``step_eval`` on the same maps.

The inputs are made from a seed with numpy: object poses near the ground
truth, so the errors cut through the recall thresholds, on the four
objects of tests/test_torch_criterions_reg.py's ``model_info`` (discrete
and continuous symmetries, diameters). Tolerances: the per-sample MSSD,
MSPD and VSD values and every mean at rtol 1e-5 (float32 sums in another
order); the recalls (AR_*) and the seen masks exactly, being counts; the
maps at rtol 1e-5 where seen and the weight map at rtol 1e-5. No value
here sits within float noise of a threshold, so no recall needs a
looser hold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.metrics import bop_ar as t_ar
from artiboost_torch.metrics import val_metric as t_val
from artiboost_tpu.metrics import bop_ar as j_ar
from artiboost_tpu.metrics import val_metric as j_val
from artiboost_tpu.utils.bop_sym import build_sym_tensor
from tests.test_torch_criterions_reg import _rotations, model_info

CCV = (4, 6, 5)
S = 64  # the crop's width and height
PRESET = {"IMAGE_SIZE": [S, S], "CENTER_IDX": 9}
RTOL = 1e-5


def make_batch(rng, B=8, V=60, padded=True, valid_tail=0):
    """Predictions and targets of one batch: ground-truth poses at 0.4-0.6 m
    and predictions off by a few degrees and centimetres."""
    rot = _rotations(rng, B)
    transf = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    transf[:, :3, :3] = rot
    transf[:, :3, 3] = rng.randn(B, 3) * 0.03 + [0, 0, 0.5]
    small = rng.randn(B, 3) * 0.08
    theta = np.linalg.norm(small, axis=1)[:, None, None]
    k = small / np.linalg.norm(small, axis=1, keepdims=True)
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    dr = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    intr = np.tile(np.array([[80.0, 0, S / 2], [0, 80.0, S / 2], [0, 0, 1]], np.float32),
                   (B, 1, 1))
    targs = {
        "obj_idx": rng.randint(1, 5, size=(B,)).astype(np.int32),
        "obj_transf": transf,
        "obj_verts_can": (rng.randn(B, V, 3) * 0.04).astype(np.float32),
        "corners_can": (rng.randn(B, 8, 3) * 0.05).astype(np.float32),
        "cam_intr": intr,
        "is_synth": (rng.rand(B) > 0.2).astype(np.int32),
        "obj_id": rng.randint(0, CCV[0], B).astype(np.int32),
        "persp_id": rng.randint(0, CCV[1], B).astype(np.int32),
        "grasp_id": rng.randint(0, CCV[2], B).astype(np.int32),
    }
    if padded:
        targs["padding_mask"] = (rng.rand(B, V) > 0.2).astype(np.float32)
    if valid_tail:
        targs["sample_valid"] = np.r_[np.ones(B - valid_tail), np.zeros(valid_tail)].astype(
            np.float32)
    preds = {"box_rot_rotmat": (dr @ rot).astype(np.float32),
             "boxroot_3d_abs": (transf[:, None, :3, 3] + rng.randn(B, 1, 3) * 0.015
                                ).astype(np.float32)}
    return preds, targs


def feeds(seed=0):
    """A padded batch, a batch without PADDING_MASK, a TEST tail of 5 valid
    rows repeat-padded to 12, and a batch of 6."""
    rng = np.random.RandomState(seed)
    return [make_batch(rng), make_batch(rng, padded=False), make_batch(rng, B=12, valid_tail=7),
            make_batch(rng, B=6)]


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _sym_args(targs):
    R, t, valid = build_sym_tensor(model_info())
    idx = np.maximum(targs["obj_idx"] - 1, 0)
    return R[idx], t[idx, ..., 0], valid[idx]


@pytest.mark.parametrize("ho3d", [False, True])
def test_mssd_and_mspd_values(ho3d):
    preds, targs = make_batch(np.random.RandomState(1))
    args = (preds["box_rot_rotmat"], preds["boxroot_3d_abs"], targs["obj_verts_can"],
            targs["padding_mask"], targs["obj_transf"])
    sym = _sym_args(targs)
    want = np.asarray(j_val.mssd_values(*map(jnp.asarray, args + sym), ho3d))
    got = t_val.mssd_values(*map(torch.from_numpy, args + sym), ho3d).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    want = np.asarray(j_val.mspd_values(*map(jnp.asarray, args + (targs["cam_intr"],) + sym),
                                        ho3d))
    got = t_val.mspd_values(*map(torch.from_numpy, args + (targs["cam_intr"],) + sym),
                            ho3d).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.all(got > 0) and np.all(np.isfinite(got))


@pytest.mark.parametrize("res,dilate", [(64, 2), (32, 0)])
def test_vsd_values(res, dilate):
    """The splatted distance maps (a scatter-min) and the discrepancy over
    ten depth tolerances; the share of pixels is a count over a count."""
    preds, targs = make_batch(np.random.RandomState(2), V=300)
    taus = (np.full((8, 1), 0.15, np.float32) * np.linspace(0.05, 0.5, 10, dtype=np.float32))
    args = (preds["box_rot_rotmat"], preds["boxroot_3d_abs"], targs["obj_verts_can"],
            targs["padding_mask"], targs["obj_transf"], targs["cam_intr"], taus)
    want = np.asarray(j_val.vsd_values(*map(jnp.asarray, args), float(S), res=res, dilate=dilate))
    got = t_val.vsd_values(*map(torch.from_numpy, args), float(S), res=res, dilate=dilate)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert 0 < got.min() and got.max() <= 1


def test_splat_depth_takes_the_nearest_point():
    px = torch.tensor([[1.5, 1.5, 2.5, 0.4, 9.0]])
    py = torch.tensor([[0.0, 0.0, 0.0, 3.0, 0.0]])
    z = torch.tensor([[0.7, 0.5, 0.6, 0.8, 0.3]])
    d = t_val._splat_depth(px, py, z, torch.tensor([[True, True, True, True, True]]), 4)
    # 1.5 and 2.5 round half to even (to 2), 9.0 falls outside
    assert d[0, 0, 2] == 0.5 and d[0, 3, 0] == pytest.approx(0.8)
    assert int((d < t_val.VSD_BIG).sum()) == 2


@pytest.mark.parametrize("corners", [False, True])
def test_val_metric_ar2_maps(corners):
    """Per-triplet MSSD in mm over four feeds, the third padded to 12 rows
    (the all-ones mask is made again for the new shape)."""
    cfg = dict(MSSD_USE_CORNERS=corners, MODEL_INFO_PATH=model_info(), CCV_SHAPE=list(CCV))
    jm, tm = j_val.ValMetricAR2(**cfg), t_val.ValMetricAR2(device="cpu", **cfg)
    for preds, targs in feeds():
        jm.feed(_j(preds), _j(targs))
        tm.feed(_t(preds), _t(targs))
    (ja, js), (ta, ts) = jm.get_averaged_maps(), tm.get_averaged_maps()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert 0 < int(ts.sum()) < ts.numel()
    np.testing.assert_allclose(ta.numpy()[ts.numpy()], np.asarray(ja)[np.asarray(js)], rtol=RTOL)
    np.testing.assert_allclose(tm.get_scalar_measures()["val_mssd_mean"],
                               jm.get_scalar_measures()["val_mssd_mean"], rtol=RTOL)
    want, got = jm.get_measures()["mssd"], tm.get_measures()["mssd"]
    assert sorted(got) == sorted(want)
    tm.reset()
    assert not bool(tm.get_averaged_maps()[1].any())


@pytest.mark.parametrize("corners,vsd", [(False, False), (True, False), (False, True)])
def test_ar_measures(corners, vsd):
    """AR after four feeds: MSSD per object, MSPD and VSD means, and the
    recalls AR_MSSD, AR_MSPD, AR_VSD, AR_BOP2 and AR_BOP; the padded rows
    of the TEST tail are dropped."""
    cfg = dict(MSSD_USE_CORNERS=corners, USE_VSD=vsd, MODEL_INFO_PATH=model_info(),
               DATA_PRESET=PRESET)
    jm, tm = j_ar.AR(**cfg), t_ar.AR(device="cpu", **cfg)
    for preds, targs in feeds(3):
        jm.feed(_j(preds), _j(targs))
        tm.feed(_t(preds), _t(targs))
    want, got = jm.get_measures(), tm.get_measures()
    assert sorted(got) == sorted(want)
    assert {"AR_MSSD", "AR_MSPD", "AR_BOP2"} <= set(got) and ("AR_BOP" in got) == vsd
    for k in want:
        if k.startswith("AR_"):
            assert got[k] == want[k], (k, got[k], want[k])
            assert 0 < got[k] < 1, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert tm._collect()[0].shape == (8 + 8 + 5 + 6,)
    np.testing.assert_allclose(tm.avg, jm.avg, rtol=RTOL)
    assert {f"MSSD_obj_{i}" for i in (1, 2, 3, 4)} <= set(got)
    tm.reset()
    assert tm.get_measures() == {"MSSD": 0.0}


def test_ar_reads_a_model_info_file(tmp_path):
    """MODEL_INFO_PATH naming a JSON file: the port takes the symmetries
    and the diameters from it, and its measures equal JAX's AR given the
    same dict. JAX's AR takes the diameters only from a dict and falls
    back to 0.2 m for a path (``artiboost_tpu/metrics/bop_ar.py:56``), a
    difference ROADMAP C records."""
    import json

    info = model_info()
    info["1"]["diameter"] = 100.0  # every object carries one, as in BOP's files
    path = tmp_path / "models_info.json"
    path.write_text(json.dumps(info))
    cfg = dict(MSSD_USE_CORNERS=False, USE_VSD=True, DATA_PRESET=PRESET)
    jm = j_ar.AR(MODEL_INFO_PATH=info, **cfg)
    tm = t_ar.AR(device="cpu", MODEL_INFO_PATH=str(path), **cfg)
    for preds, targs in feeds(3):
        jm.feed(_j(preds), _j(targs))
        tm.feed(_t(preds), _t(targs))
    want, got = jm.get_measures(), tm.get_measures()
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("AR_"):
            assert got[k] == want[k], (k, got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(tm.diameters, np.float32([0.1, 0.15, 0.12, 0.2]))
    np.testing.assert_array_equal(tm.diameters, jm.diameters)
    assert np.all(j_ar.AR(MODEL_INFO_PATH=str(path), **cfg).diameters == np.float32(0.2))


def test_dexycb_evaluator_builds_ar():
    """The DexYCB recipe's evaluator: every metric built, AR and ValMetricAR2
    included, and the scalar view names them as JAX's does."""
    from artiboost_torch.metrics.evaluator import build_evaluator as t_build
    from artiboost_torch.utils.config import load_config
    from artiboost_tpu.metrics import build_evaluator as j_build

    cfg = load_config("config/dexycb_clasbased_sym_artiboost.yaml")
    metrics = [m for m in cfg["EVALUATOR"] if m["TYPE"] not in ("Vis2DMetric",)]
    for m in metrics:
        if m["TYPE"] == "ValMetricMean3DEPE2" or m["TYPE"] == "ValMetricAR2":
            m["CCV_SHAPE"] = list(CCV)
    t_ev = t_build(cfg["EVALUATOR"], cfg["DATA_PRESET"], device="cpu")
    assert [type(m).__name__ for m in t_ev.metrics_list] == [m["TYPE"] for m in cfg["EVALUATOR"]]
    j_ev, t_ev = j_build(metrics, PRESET), t_build(metrics, PRESET, device="cpu")
    rng = np.random.RandomState(4)
    for _ in range(2):
        preds, targs = make_batch(rng, V=40)
        targs.update(joints_3d=(rng.randn(8, 21, 3) * 0.05).astype(np.float32),
                     corners_3d=(rng.randn(8, 8, 3) * 0.05).astype(np.float32),
                     root_joint=(rng.randn(8, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32),
                     joints_vis=np.ones((8, 21), np.float32))
        preds.update(joints_3d_abs=targs["joints_3d"] + targs["root_joint"][:, None] + 0.01,
                     corners_3d_abs=targs["corners_3d"] + targs["root_joint"][:, None] - 0.01)
        losses = {"final_loss": np.float32(0.5)}
        j_ev.feed_all(_j(preds), _j(targs), {k: jnp.asarray(v) for k, v in losses.items()})
        t_ev.feed_all(_t(preds), _t(targs), {k: torch.tensor(v) for k, v in losses.items()})
    want, got = j_ev.get_measures_all_striped(), t_ev.get_measures_all_striped()
    assert sorted(got) == sorted(want) and "AR" in got and "ValMetricAR2" in got
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=RTOL, err_msg=(name, k))


def _bare_loaders(jax_ccv, torch_ccv):
    """The JAX and the port's ArtiBoostLoader holding only what ``step_eval``
    and ``sample_reweight`` read (the released recipes' mining settings),
    so the mining step is held without building the synthesis engine."""
    from artiboost_torch.artiboost.loader import ArtiBoostLoader as TLoader
    from artiboost_tpu.artiboost.loader import ArtiBoostLoader as JLoader

    out = []
    for cls, ccv in ((JLoader, jax_ccv), (TLoader, torch_ccv)):
        loader = object.__new__(cls)
        loader.__dict__.update(
            use_synth=True, epoch_idx=0, ccv=ccv, update_method_key="method_1",
            weight_lower=0.1, weight_upper=10.0, dist_lower=8.0, dist_upper=16.0,
            n_epochs=2, synth_shutdown_ratio=0.0, real_dataset=None,
            last_dist_lower_ratio=-1.0)
        out.append(loader)
    return out


def test_step_eval_with_both_val_metrics():
    """The DexYCB recipe's mining: ``step_eval`` averages the EPE and the MSSD
    maps and ANDs their seen masks; the new weight map against the JAX
    loader's on the same evaluators' feeds."""
    from artiboost_torch.artiboost import ccv as t_ccv
    from artiboost_tpu.artiboost import ccv as j_ccv

    epe_cfg = dict(VAL_KEYS=["corners_3d_abs"], MILLIMETERS=True, CCV_SHAPE=list(CCV))
    ar_cfg = dict(MSSD_USE_CORNERS=True, MODEL_INFO_PATH=model_info(), CCV_SHAPE=list(CCV))
    jms = [j_val.ValMetricMean3DEPE2(**epe_cfg), j_val.ValMetricAR2(**ar_cfg)]
    tms = [t_val.ValMetricMean3DEPE2(device="cpu", **epe_cfg),
           t_val.ValMetricAR2(device="cpu", **ar_cfg)]
    rng = np.random.RandomState(5)
    for i, (preds, targs) in enumerate(feeds(6)):
        B = targs["obj_idx"].shape[0]
        root = (rng.randn(B, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32)
        targs.update(root_joint=root, corners_3d=(rng.randn(B, 8, 3) * 0.05).astype(np.float32))
        preds["corners_3d_abs"] = (targs["corners_3d"] + root[:, None]
                                   + rng.randn(B, 8, 3) * 0.01).astype(np.float32)
        feed_ar = i != 1  # the EPE sees a batch the MSSD does not: the AND matters
        for m in jms[:1] + (jms[1:] if feed_ar else []):
            m.feed(_j(preds), _j(targs))
        for m in tms[:1] + (tms[1:] if feed_ar else []):
            m.feed(_t(preds), _t(targs))

    class Ev:
        def __init__(self, metrics):
            self.metrics_list = metrics

    w0 = np.random.RandomState(7).uniform(0.5, 2.0, CCV).astype(np.float32)
    jl, tl = _bare_loaders(j_ccv.init_ccv_space(*CCV)._replace(sample_weight_map=jnp.asarray(w0)),
                           t_ccv.init_ccv_space(*CCV, device="cpu")._replace(
                               sample_weight_map=torch.from_numpy(w0)))
    jl.step_eval(1, Ev(jms))
    tl.step_eval(1, Ev(tms))
    seen_epe, seen_ar = (m.get_averaged_maps()[1].numpy() for m in tms)
    assert (seen_epe & ~seen_ar).any()  # the AND removes triplets only the EPE saw
    want = np.asarray(jl.ccv.sample_weight_map)
    got = tl.ccv.sample_weight_map.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    both = seen_epe & seen_ar
    assert np.all(got[~both] == w0[~both]) and not np.all(got[both] == w0[both])
    assert tl.epoch_idx == 1
