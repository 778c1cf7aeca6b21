"""The port's metrics (``artiboost_torch/metrics``) against the JAX
package's on the same numpy inputs, made from a seed: the four PCK metrics
(curves, per-keypoint AUC, ``auc_all``, ``epe_mean_all``), Mean2DEPE,
``ValMetricMean3DEPE2``'s scalar and per-triplet views, the evaluator's
scalar-only view, and the Vis2D / VisHand2D images.

Tolerances: rtol 1e-6 on every number (both sides compute float32 norms;
the curves are fractions of counts and agree exactly); the images pixel
for pixel, from a float32 batch and from a bfloat16 one."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from artiboost_torch.metrics import evaluator as t_eval
from artiboost_torch.metrics import meanepe as t_epe
from artiboost_torch.metrics import pckmetric as t_pck
from artiboost_torch.metrics import val_metric as t_val
from artiboost_torch.metrics import vismetric as t_vis
from artiboost_tpu.metrics import evaluator as j_eval
from artiboost_tpu.metrics import meanepe as j_epe
from artiboost_tpu.metrics import pckmetric as j_pck
from artiboost_tpu.metrics import val_metric as j_val
from artiboost_tpu.metrics import vismetric as j_vis

RTOL = 1e-6
CCV = (3, 8, 5)
PRESET = {"IMAGE_SIZE": [32, 32], "CENTER_IDX": 0}


def make_batch(rng, B, valid_tail=0, H=32, W=32):
    """Predictions and targets of one batch (metres and pixels at realistic
    scales, so the PCK thresholds cut through the distances); the last
    ``valid_tail`` rows are repeat padding (SAMPLE_VALID 0)."""
    root = rng.uniform(-0.1, 0.1, (B, 3)).astype(np.float32)
    root[:, 2] += 0.5
    joints = rng.normal(0, 0.04, (B, 21, 3)).astype(np.float32)
    corners = rng.normal(0, 0.06, (B, 8, 3)).astype(np.float32)
    intr = np.tile(np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32),
                   (B, 1, 1))
    targs = {
        "root_joint": root, "joints_3d": joints, "corners_3d": corners,
        "joints_2d": rng.uniform(0, W, (B, 21, 2)).astype(np.float32),
        "corners_2d": rng.uniform(0, W, (B, 8, 2)).astype(np.float32),
        "joints_vis": (rng.rand(B, 21) > 0.2).astype(np.float32),
        "corners_vis": (rng.rand(B, 8) > 0.2).astype(np.float32),
        "cam_intr": intr,
        "image": rng.uniform(-0.5, 0.5, (B, H, W, 3)).astype(np.float32),
        "is_synth": (rng.rand(B) > 0.3).astype(np.int32),
        "obj_id": rng.randint(0, CCV[0], B).astype(np.int32),
        "persp_id": rng.randint(0, CCV[1], B).astype(np.int32),
        "grasp_id": rng.randint(0, CCV[2], B).astype(np.int32),
    }
    if valid_tail:
        targs["sample_valid"] = np.r_[np.ones(B - valid_tail), np.zeros(valid_tail)].astype(
            np.float32)
    preds = {
        "joints_3d_abs": joints + root[:, None] + rng.normal(0, 0.02, (B, 21, 3)).astype(
            np.float32),
        "corners_3d_abs": corners + root[:, None] + rng.normal(0, 0.03, (B, 8, 3)).astype(
            np.float32),
        "joints_2d": targs["joints_2d"] + rng.normal(0, 4.0, (B, 21, 2)).astype(np.float32),
        "corners_2d": targs["corners_2d"] + rng.normal(0, 4.0, (B, 8, 2)).astype(np.float32),
        "2d_uvd": rng.uniform(0, 1, (B, 22, 3)).astype(np.float32),
    }
    losses = {"final_loss": np.float32(rng.rand()), "joints_3d_loss": np.float32(rng.rand()),
              "unused": None}
    return preds, targs, losses


def batches(seed, valid_tail):
    rng = np.random.RandomState(seed)
    return [make_batch(rng, 6), make_batch(rng, 5), make_batch(rng, 6, valid_tail)]


def to_jax(tree):
    return {k: None if v is None else jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree):
    return {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def feed_both(j_metric, t_metric, data):
    for preds, targs, _ in data:
        j_metric.feed(to_jax(preds), to_jax(targs))
        t_metric.feed(to_torch(preds), to_torch(targs))


PCK_CASES = [("Hand3DPCKMetric", 0.0, 0.05, 20), ("Obj3DPCKMetric", 0.0, 0.05, 20),
             ("Hand2DPCKMetric", 0.0, 10.0, 15), ("Obj2DPCKMetric", 0.0, 10.0, 15)]


@pytest.mark.parametrize("valid_tail", [0, 3])
@pytest.mark.parametrize("name,vmin,vmax,steps", PCK_CASES)
def test_pck_against_jax(name, vmin, vmax, steps, valid_tail):
    cfg = {"VAL_MIN": vmin, "VAL_MAX": vmax, "STEPS": steps, "DATA_PRESET": PRESET}
    j_metric, t_metric = getattr(j_pck, name)(**cfg), getattr(t_pck, name)(**cfg)
    feed_both(j_metric, t_metric, batches(11, valid_tail))
    want, got = j_metric.get_measures(), t_metric.get_measures()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)
    np.testing.assert_array_equal(got["pck_curve_per_kp"], want["pck_curve_per_kp"])
    curve = got["pck_curve_per_kp"]
    assert 0 < curve.mean() < 1  # the thresholds cut through the distances
    assert str(t_metric) == str(j_metric)
    if valid_tail:  # the padded rows count as invisible
        no_tail = getattr(t_pck, name)(**cfg)
        data = batches(11, valid_tail)
        preds, targs, _ = data[-1]
        data[-1] = ({k: v[:-valid_tail] for k, v in preds.items()},
                    {k: v[:-valid_tail] for k, v in targs.items() if k != "sample_valid"}, None)
        for p, t, _ in data:
            no_tail.feed(to_torch(p), to_torch(t))
        np.testing.assert_array_equal(no_tail.get_measures()["epe_mean_per_kp"],
                                      got["epe_mean_per_kp"])


@pytest.mark.parametrize("valid_tail", [0, 2])
def test_mean2depe_against_jax(valid_tail):
    cfg = {"VAL_KEYS": ["joints_2d", "corners_2d"], "MILLIMETERS": True}
    j_metric = j_epe.Mean2DEPE(**cfg)
    t_metric = t_epe.Mean2DEPE(device="cpu", **cfg)
    feed_both(j_metric, t_metric, batches(12, valid_tail))
    want, got = j_metric.get_measures(), t_metric.get_measures()
    assert set(got) == set(want) == {"joints_2d_mepe", "corners_2d_mepe"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)
    assert 1.0 < got["joints_2d_mepe"] < 20.0  # pixels: MILLIMETERS is forced off


def test_val_metric_views_against_jax():
    cfg = {"VAL_KEYS": ["corners_3d_abs", "joints_3d_abs"], "MILLIMETERS": True,
           "CCV_SHAPE": list(CCV)}
    j_metric = j_val.ValMetricMean3DEPE2(**cfg)
    t_metric = t_val.ValMetricMean3DEPE2(device="cpu", **cfg)
    feed_both(j_metric, t_metric, batches(13, 0))
    want, got = j_metric.get_scalar_measures(), t_metric.get_scalar_measures()
    assert set(got) == set(want) == {"val_epe_mean"}
    np.testing.assert_allclose(got["val_epe_mean"], want["val_epe_mean"], rtol=RTOL, atol=0)
    want, got = j_metric.get_measures(), t_metric.get_measures()
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]) and len(got[key]) > 3
        np.testing.assert_allclose([got[key][t] for t in want[key]], list(want[key].values()),
                                   rtol=RTOL, atol=0, err_msg=key)
    assert str(t_metric) == ""


EVAL_CFG = [
    {"TYPE": "LossesMetric", "VIS_LOSS_KEYS": ["joints_3d_loss"]},
    {"TYPE": "Hand3DPCKMetric", "VAL_MIN": 0.0, "VAL_MAX": 0.05, "STEPS": 20},
    {"TYPE": "Obj3DPCKMetric", "VAL_MIN": 0.0, "VAL_MAX": 0.05, "STEPS": 20},
    {"TYPE": "Mean3DEPE", "VAL_KEYS": ["corners_3d_abs", "joints_3d_abs"], "MILLIMETERS": True},
    {"TYPE": "Mean2DEPE", "VAL_KEYS": ["joints_2d"]},
    {"TYPE": "Vis2DMetric", "NCOL": 2, "NROW": 2},
    {"TYPE": "ValMetricMean3DEPE2", "VAL_KEYS": ["corners_3d_abs", "joints_3d_abs"],
     "MILLIMETERS": True, "CCV_SHAPE": list(CCV)},
]


def fed_evaluators(seed=14, valid_tail=2):
    """The JAX and the port's evaluator of ``EVAL_CFG``, fed the same
    batches (the last with a padded tail)."""
    import artiboost_tpu.metrics  # noqa: F401  (registers the JAX metrics)

    j = j_eval.build_evaluator(EVAL_CFG, PRESET)
    t = t_eval.build_evaluator(EVAL_CFG, PRESET, device="cpu")
    for preds, targs, losses in batches(seed, valid_tail):
        j.feed_all(to_jax(preds), to_jax(targs), to_jax(losses))
        t.feed_all(to_torch(preds), to_torch(targs), to_torch(losses))
    return j, t


def test_evaluator_striped_view_against_jax(caplog):
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        j, t = fed_evaluators()
    assert not [r for r in caplog.records if "not ported" in r.message]
    assert [type(m).__name__ for m in t.metrics_list] == [c["TYPE"] for c in EVAL_CFG]
    want, got = j.get_measures_all_striped(), t.get_measures_all_striped()
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=RTOL, atol=0,
                                       err_msg=f"{name}/{k}")
    assert "Vis2DMetric" not in got
    assert t.get_measures_all_striped(return_losses=False).keys() == \
        j.get_measures_all_striped(return_losses=False).keys()
    assert list(t.get_measures_all()) == list(j.get_measures_all())
    assert t.losses_metric is t.metrics_list[0]
    assert str(t).split(" | ")[:2] == str(j).split(" | ")[:2]
    assert "vis2d" not in str(t)


def test_build_evaluator_passes_data_preset_and_skips_unknown(caplog):
    seen = {}

    class Probe:
        def __init__(self, **cfg):
            seen.update(cfg)

    t_eval.METRICS["Probe"] = Probe
    try:
        t_eval.build_evaluator([{"TYPE": "Probe", "X": 1}], PRESET, device="cpu")
    finally:
        del t_eval.METRICS["Probe"]
    assert seen["DATA_PRESET"] == PRESET and seen["X"] == 1
    # an unknown TYPE raises as JAX's registry does (it used to be skipped)
    with pytest.raises(KeyError, match="NoSuchMetric is not in the metric registry"):
        t_eval.build_evaluator([{"TYPE": "NoSuchMetric"}], device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["Vis2DMetric", "VisHand2DMetric"])
def test_vis_images_against_jax(name, dtype):
    rng = np.random.RandomState(15)
    preds, targs, _ = make_batch(rng, 5, H=24, W=32)
    targs["image"] = targs["image"] * 1.3  # some values clip at 0 and 255
    cfg = {"NCOL": 3, "NROW": 2, "DATA_PRESET": PRESET}
    j_metric, t_metric = getattr(j_vis, name)(**cfg), getattr(t_vis, name)(**cfg)
    jt, tt = to_jax(targs), to_torch(targs)
    if dtype == "bfloat16":
        img = targs["image"].astype(ml_dtypes.bfloat16)
        jt["image"] = jnp.asarray(img)
        tt["image"] = torch.from_numpy(img.astype(np.float32)).to(torch.bfloat16)
    for _ in range(2):  # only the first batch of an epoch is drawn
        j_metric.feed(to_jax(preds), jt)
        t_metric.feed(to_torch(preds), tt)
    want, got = np.asarray(j_metric.images), np.asarray(t_metric.images)
    assert got.shape == want.shape == (2 * 24, 3 * 32, 3)
    np.testing.assert_array_equal(got, want)
    assert t_metric.count == 5 and t_metric.get_measures() == {}
    bare = getattr(t_vis, name)(**cfg)
    bare.feed({}, tt)
    assert (np.asarray(bare.images) != got).any(-1).mean() > 0.01  # the overlay is drawn
    t_metric.reset()
    assert t_metric.images is None
