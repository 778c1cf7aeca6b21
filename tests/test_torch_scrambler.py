"""The anatomically-aware scramblers ``random_2`` and ``random_3`` and the
joint axes they read (``artiboost_torch/mano/axis_layer.py``) against the
JAX package, on the same MANO feed and with the JAX draws injected.

Tolerances: ``hand_axes`` within 1e-6 (unit vectors from the same joints
and transforms). The scrambled poses within 1e-5: each composes axis-angle
rotations through ``aa_to_rotmat`` and back through ``rotmat_to_aa``, and
XLA's sin/cos differ from torch's in the last bit (ROADMAP C). The pose
generator with either scrambler within 1e-5, as
``tests/test_torch_engine.py`` holds it with ``random``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.artiboost.pose_generator import PoseGenerator as t_make_pg
from artiboost_torch.artiboost.refiner import make_null_refiner as t_null
from artiboost_torch.artiboost.scrambler import SCRAMBLERS, Scrambler, axis_angle_op
from artiboost_torch.mano.axis_layer import hand_axes as t_hand_axes
from artiboost_torch.mano.layer import mano_forward as t_mano_forward
from artiboost_tpu.artiboost import scrambler as j_scr
from artiboost_tpu.artiboost.pose_generator import make_pose_generator as j_make_pg
from artiboost_tpu.artiboost.refiner import make_null_refiner as j_null
from artiboost_tpu.mano.axis_layer import hand_axes as j_hand_axes
from artiboost_tpu.mano.layer import mano_forward as j_mano_forward
from test_torch_engine import (OBJS, JViewCfg, TViewCfg, j_grasps, j_mano, j_objs,
                               jax_view_scram_draws, t_grasps, t_mano, t_objs)

B = 12
N_BEND = {"random_2": 5, "random_3": 14}


@pytest.fixture(scope="module")
def feed():
    """A MANO feed as the pose generator builds it: a seeded pose, its FK
    joints with the translation added and the absolute transforms."""
    rng = np.random.RandomState(5)
    pose = (rng.randn(B, 48) * 0.3).astype(np.float32)
    shape = (rng.randn(B, 10) * 0.5).astype(np.float32)
    tsl = (rng.randn(B, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    out = j_mano_forward(j_mano(), jnp.asarray(pose), jnp.asarray(shape))
    return {"hand_pose": pose, "hand_tsl": tsl,
            "joints": np.asarray(out.joints) + tsl[:, None],
            "hand_transf": np.asarray(out.transforms_abs)}


def _jax_draws(key, kind):
    """The draws of ``random_2`` / ``random_3`` (``split(key, 4)``)."""
    keys = jax.random.split(key, 4)
    return {k: torch.from_numpy(np.array(jax.random.normal(kk, (B, n))))
            for k, kk, n in (("tsl", keys[0], 3), ("splay", keys[1], 4),
                             ("bend", keys[2], N_BEND[kind]), ("other", keys[3], 2))}


def test_hand_axes(feed):
    j_axes = j_hand_axes(jnp.asarray(feed["joints"]), jnp.asarray(feed["hand_transf"]))
    t_axes = t_hand_axes(torch.from_numpy(feed["joints"]), torch.from_numpy(feed["hand_transf"]))
    for a, b in zip(t_axes, j_axes):
        assert a.shape == (B, 15, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(a.numpy(), axis=-1), 1.0, atol=1e-6)


def test_axis_angle_op():
    rng = np.random.RandomState(2)
    a, b = (rng.randn(B, 4, 3).astype(np.float32) * 0.5 for _ in range(2))
    np.testing.assert_allclose(axis_angle_op(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax.jit(j_scr.axis_angle_op)(a, b)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["random_2", "random_3"])
def test_scrambler_with_jax_draws(feed, kind):
    cfg = {"TYPE": kind, "HAND_TSL_SIGMA": 0.01, "HAND_POSE_SIGMA": 0.1}
    key = jax.random.PRNGKey(17)
    j_feed = {k: jnp.asarray(v) for k, v in feed.items()}
    j_out = jax.jit(j_scr.build_scrambler(cfg))(key, j_feed)
    scr = Scrambler(cfg)
    draws = _jax_draws(key, kind)
    own = scr.draws(torch.Generator().manual_seed(0), B, "cpu")
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in draws.items()}
    t_out = scr({k: torch.from_numpy(v) for k, v in feed.items()}, draws)
    for k in ("hand_pose", "hand_tsl"):
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    moved = np.abs(t_out["hand_pose"].numpy() - feed["hand_pose"]).reshape(B, 16, 3).max(-1)
    # the wrist never moves; every finger joint the scrambler touches does
    assert (moved[:, 0] == 0).all() and (moved[:, 1:] > 0).all()


@pytest.mark.parametrize("kind", ["random_2", "random_3"])
def test_pose_generator_with_scrambler(kind):
    cfg = {"TYPE": kind, "HAND_TSL_SIGMA": 0.01, "HAND_POSE_SIGMA": 0.1}
    vcfg_j, vcfg_t = JViewCfg(6, 8), TViewCfg(6, 8)
    jm, tm = j_mano(), t_mano()
    jgen = j_make_pg(jm, j_objs(OBJS), j_grasps(4, 16), vcfg_j, j_scr.build_scrambler(cfg),
                     j_null(jm))
    tgen = t_make_pg(tm, t_objs(OBJS), t_grasps(4, 16), vcfg_t, Scrambler(cfg), t_null(tm))
    rng = np.random.RandomState(7)
    oid, vid, gid = rng.randint(0, 4, B), rng.randint(0, 48, B), rng.randint(0, 16, B)
    key = jax.random.PRNGKey(11)
    jout = jax.jit(jgen)(key, jnp.asarray(oid), jnp.asarray(vid), jnp.asarray(gid))
    draws = jax_view_scram_draws(key, B, vcfg_j)
    draws["scram"] = _jax_draws(jax.random.split(key)[1], kind)
    tout = tgen(torch.from_numpy(oid), torch.from_numpy(vid), torch.from_numpy(gid), draws)
    for name in jout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    out = t_mano_forward(tm, tout.hand_pose, tout.hand_shape)
    assert torch.isfinite(out.verts).all()


def test_registry():
    assert set(SCRAMBLERS) == set(j_scr.SCRAMBLER_REGISTRY) == {"naive", "random", "random_2",
                                                                "random_3"}
    with pytest.raises(ValueError, match="unknown scrambler"):
        Scrambler({"TYPE": "random_9"})
