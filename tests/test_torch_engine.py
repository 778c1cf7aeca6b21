"""The ArtiBoost engine of the port against the JAX package: CCV triplet
sampling and the blacklist, the pose generator with the JAX draws
injected, the per-triplet val metric and the five mining updates.

Tolerances: blacklist, seen masks and occurrence maps exact; the pose
cache at atol 1e-5 (float32 FK in another summation order); val maps and
mining updates at rtol 1e-6. The port's own sampler draws from a torch
Generator, which never reproduces JAX's threefry bits, so it is held by
distribution: a chi-square test against the weights (p > 1e-3 on a fixed
seed), no blacklisted draw, distinct ids without replacement."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from artiboost_torch.artiboost import ccv as t_ccv
from artiboost_torch.artiboost import mining as t_mining
from artiboost_torch.artiboost.grasp_library import synthetic_grasp_library
from artiboost_torch.artiboost.object_library import synthetic_object_library
from artiboost_torch.artiboost.pose_generator import PoseGenerator as t_make_pg
from artiboost_torch.artiboost.refiner import make_null_refiner as t_null
from artiboost_torch.artiboost.scrambler import Scrambler as t_scrambler
from artiboost_torch.artiboost.view_engine import ViewEngineConfig as TViewCfg
from artiboost_torch.artiboost.view_engine import persp_rotmat_centers
from artiboost_torch.mano.model import synthetic_mano_model
from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
from artiboost_tpu.artiboost import ccv as j_ccv
from artiboost_tpu.artiboost import mining as j_mining
from artiboost_tpu.artiboost.grasp_library import synthetic_grasp_library as j_grasps
from artiboost_tpu.artiboost.object_library import synthetic_object_library as j_objs
from artiboost_tpu.artiboost.pose_generator import make_pose_generator as j_make_pg
from artiboost_tpu.artiboost.refiner import make_null_refiner as j_null
from artiboost_tpu.artiboost.scrambler import build_scrambler as j_scrambler
from artiboost_tpu.artiboost.view_engine import ViewEngineConfig as JViewCfg
from artiboost_tpu.artiboost.view_engine import persp_rotmat_centers as j_centers
from artiboost_tpu.mano.model import synthetic_mano_model as j_mano
from artiboost_tpu.metrics.val_metric import ValMetricMean3DEPE2 as JValMetric

OBJS = ["o0", "o1", "o2", "o3"]
SCRAM = {"TYPE": "random", "HAND_TSL_SIGMA": 0.01, "HAND_POSE_SIGMA": 0.1}
# the port's constructors run on CUDA unless asked for the CPU
t_grasps = partial(synthetic_grasp_library, device="cpu")
t_objs = partial(synthetic_object_library, device="cpu")
t_centers = partial(persp_rotmat_centers, device="cpu")
t_mano = partial(synthetic_mano_model, device="cpu")
TValMetric = partial(ValMetricMean3DEPE2, device="cpu")


def jax_view_scram_draws(key, B, cfg):
    """The draws ``artiboost_tpu`` makes inside generate(key, ...)."""
    k_view, k_scram = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k_view, 3)
    ku, kt = jax.random.split(k1)
    s1, s2 = jax.random.split(k_scram)
    t = lambda a: torch.from_numpy(np.array(a))
    return {"view": {"u": t(jax.random.uniform(ku, (B,))),
                     "theta": t(jax.random.uniform(kt, (B,))),
                     "roll": t(jax.random.uniform(k2, (B,))),
                     "z": t(jax.random.uniform(k3, (B,), minval=cfg.camera_z_min,
                                               maxval=cfg.camera_z_max))},
            "scram": {"tsl": t(jax.random.normal(s1, (B, 3))),
                      "ang": t(jax.random.normal(s2, (B, 16)))}}


def test_blacklist_exact():
    for u_bins, t_bins, n_grasp in ((6, 8, 16), (12, 24, 50)):
        jb = j_ccv.build_blacklist_map(None, j_grasps(4, n_grasp).hand_pose,
                                       j_centers(JViewCfg(u_bins, t_bins)))
        tb = t_ccv.build_blacklist_map(t_grasps(4, n_grasp).hand_pose,
                                       t_centers(TViewCfg(u_bins, t_bins)))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert 0 < float(tb.mean()) < 0.5


@pytest.mark.parametrize("replace", [True, False])
def test_occurrence_from_jax_ids(replace):
    rng = np.random.RandomState(3)
    w = (rng.rand(4, 48, 16) * 2).astype(np.float32)
    bl = (rng.rand(4, 48, 16) < 0.1).astype(np.float32)
    occ0 = rng.randint(0, 3, (4, 48, 16)).astype(np.int32)
    js = j_ccv.CCVSpace(jnp.asarray(w), jnp.asarray(occ0), jnp.asarray(bl))
    oid, vid, gid, occ = j_ccv.sample_triplets(js, jax.random.PRNGKey(5), 200, replace=replace)
    flat = torch.from_numpy(np.asarray(j_ccv.ovg_to_flat(oid, vid, gid, 48, 16)).astype(np.int64))
    ts = t_ccv.CCVSpace(torch.from_numpy(w), torch.from_numpy(occ0), torch.from_numpy(bl))
    t_oid, t_vid, t_gid, t_occ = t_ccv.triplets_from_flat(ts, flat)
    for a, b in ((oid, t_oid), (vid, t_vid), (gid, t_gid), (occ, t_occ)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sampler_distribution():
    rng = np.random.RandomState(4)
    w = (rng.rand(2, 3, 4) * 3 + 0.2).astype(np.float32)
    bl = np.zeros_like(w)
    bl.reshape(-1)[[1, 7, 13]] = 1.0
    space = t_ccv.init_ccv_space(2, 3, 4, torch.from_numpy(bl), device="cpu")
    space = space._replace(sample_weight_map=torch.from_numpy(w))
    g = torch.Generator().manual_seed(0)
    n = 40000
    flat = t_ccv.sample_triplets_draws(space, g, n, replace=True).numpy()
    counts = np.bincount(flat, minlength=24)
    assert counts[[1, 7, 13]].sum() == 0
    keep = bl.reshape(-1) == 0
    p = (w.reshape(-1).astype(np.float64) * keep)[keep]
    expected = p / p.sum() * n
    assert stats.chisquare(counts[keep], expected).pvalue > 1e-3

    flat = t_ccv.sample_triplets_draws(space, g, 21, replace=False).numpy()
    assert len(set(flat.tolist())) == 21 and keep[flat].all()
    # the first pick of a Gumbel top-k is a categorical draw
    firsts = np.array([int(t_ccv.sample_triplets_draws(space, g, 1, replace=False)[0])
                       for _ in range(3000)])
    counts = np.bincount(firsts, minlength=24)[keep]
    assert stats.chisquare(counts, p / p.sum() * 3000).pvalue > 1e-3


def test_pose_generator_injected_draws():
    vcfg_j, vcfg_t = JViewCfg(6, 8), TViewCfg(6, 8)
    jm, tm = j_mano(), t_mano()
    jgen = j_make_pg(jm, j_objs(OBJS), j_grasps(4, 16), vcfg_j, j_scrambler(SCRAM), j_null(jm))
    tgen = t_make_pg(tm, t_objs(OBJS), t_grasps(4, 16), vcfg_t, t_scrambler(SCRAM), t_null(tm))
    rng = np.random.RandomState(7)
    B = 24
    oid, vid, gid = rng.randint(0, 4, B), rng.randint(0, 48, B), rng.randint(0, 16, B)
    key = jax.random.PRNGKey(11)
    jout = jgen(key, jnp.asarray(oid), jnp.asarray(vid), jnp.asarray(gid))
    tout = tgen(torch.from_numpy(oid), torch.from_numpy(vid), torch.from_numpy(gid),
                jax_view_scram_draws(key, B, vcfg_j))
    for name in jout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


def _val_batches(rng, n_batches=3, B=16, shape=(4, 48, 16)):
    for _ in range(n_batches):
        yield ({"joints_3d_abs": rng.randn(B, 21, 3).astype(np.float32) * 0.1,
                "corners_3d_abs": rng.randn(B, 8, 3).astype(np.float32) * 0.1},
               {"joints_3d": rng.randn(B, 21, 3).astype(np.float32) * 0.1,
                "corners_3d": rng.randn(B, 8, 3).astype(np.float32) * 0.1,
                "root_joint": rng.randn(B, 3).astype(np.float32),
                "is_synth": (rng.rand(B) > 0.2).astype(np.int32),
                "obj_id": rng.randint(-1, shape[0], B).astype(np.int32),
                "persp_id": rng.randint(0, shape[1], B).astype(np.int32),
                "grasp_id": rng.randint(0, 3, B).astype(np.int32)})


def test_val_metric_maps():
    cfg = dict(VAL_KEYS=["corners_3d_abs", "joints_3d_abs"], MILLIMETERS=True,
               CCV_SHAPE=[4, 48, 16])
    jm, tm = JValMetric(**cfg), TValMetric(**cfg)
    for preds, targs in _val_batches(np.random.RandomState(8)):
        jm.feed({k: jnp.asarray(v) for k, v in preds.items()},
                {k: jnp.asarray(v) for k, v in targs.items()})
        tm.feed({k: torch.from_numpy(v) for k, v in preds.items()},
                {k: torch.from_numpy(v) for k, v in targs.items()})
    (ja, js), (ta, ts) = jm.get_averaged_maps(), tm.get_averaged_maps()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert 0 < int(ts.sum()) < ts.numel()
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)


@pytest.mark.parametrize("method,epoch", [("method_1", 0), ("method_2", 0), ("method_3", 0),
                                          ("method_4", 10), ("method_4", 90), ("uniform", 0)])
def test_mining_updates(method, epoch):
    rng = np.random.RandomState(9)
    w = (rng.rand(4, 48, 16) * 3).astype(np.float32)
    val = (rng.rand(4, 48, 16) * 30).astype(np.float32)
    seen = rng.rand(4, 48, 16) > 0.5
    kw = dict(dist_lower_threshold=8.0, dist_upper_threshold=16.0, epoch_idx=epoch,
              n_epochs=100)
    jo = j_mining.UPDATE_METHODS[method](jnp.asarray(w), jnp.asarray(val), jnp.asarray(seen),
                                         0.1, 10.0, **kw)
    to = t_mining.UPDATE_METHODS[method](torch.from_numpy(w), torch.from_numpy(val),
                                         torch.from_numpy(seen), 0.1, 10.0, **kw)
    assert set(jo) == set(to)
    for k in jo:
        np.testing.assert_allclose(np.asarray(to[k]), np.asarray(jo[k]), rtol=1e-6, atol=0,
                                   err_msg=k)
