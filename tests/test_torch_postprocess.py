"""The port's IKNet and FittingUnit (``artiboost_torch/postprocess``) against
the JAX package's, from the same weights (``assets/iknet_tpu.npz``) and the
same target joints (a seeded MANO pose of the synthetic model).

Tolerances:
- IKNet's quaternions within 1e-5 (measured 1.2e-7). Its so3 as rotations
  within 1e-5 and as axis-angle within 5e-5: ``quat_to_aa`` of a
  quaternion with w near -1 gives an angle near 2 pi on an axis
  xyz / |xyz| with |xyz| ~ 1e-2, which turns the quaternions' 1e-7 into
  up to 2.2e-5 (measured; the same quaternions through both packages'
  ``quat_to_aa`` agree to 4.8e-7).
- ``geo_prior`` and the fitting residual within 1e-6 relative; step 0's
  gradient within 1e-5 of its norm.
- The iknet fit (20 Adam steps): joints and verts within 5e-5 m (measured
  7.5e-6 m), so3 within 5e-4 (measured 7.8e-5).
- The iksolver fit from the flat hand: at 20 steps held as the iknet fit
  (so3 measured 4.1e-5). At its 100 steps the two packages part by up to
  6.5e-3 m on the joints and 0.106 on so3 (measured; 4.2e-2 at 50 steps;
  ROADMAP C): Adam with b2 = 0.5 takes steps of about lr whatever the
  gradient's size, so near the minimum float noise in a small gradient
  moves a step. Each package must improve on the flat start as JAX's own
  test asks (under 0.7 of its error), and the two mean joint errors lie
  within 1 mm of each other (measured 3.32 and 3.25 mm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.mano.model import synthetic_mano_model as t_mano
from artiboost_torch.postprocess import fitting as t_fit
from artiboost_torch.postprocess.iknet import IKNet as TIKNet
from artiboost_torch.utils.convert import FROM_FLAX, iknet_from_flax, load_flax_npz
from artiboost_torch.utils.misc import asset_path
from artiboost_torch.utils.transform import aa_to_rotmat
from artiboost_tpu.mano import mano_forward as j_mano_forward
from artiboost_tpu.mano import synthetic_mano_model as j_mano
from artiboost_tpu.postprocess import fitting as j_fit
from artiboost_tpu.postprocess.iknet import IKNet as JIKNet

B = 8
WEIGHTS = asset_path("assets/iknet_tpu.npz")


@pytest.fixture(scope="module")
def models():
    return j_mano(), t_mano(device="cpu")


@pytest.fixture(scope="module")
def target(models):
    """Joints of a seeded MANO pose, 0.5 m in front of the camera."""
    pose = np.random.RandomState(0).randn(B, 48).astype(np.float32) * 0.2
    out = j_mano_forward(models[0], jnp.asarray(pose), jnp.zeros((B, 10)))
    return np.asarray(out.joints) + np.float32([0.0, 0.0, 0.5])


def _normalised(target):
    j = target - target[:, :1]
    return (j / np.linalg.norm(j[:, 9] - j[:, 0], axis=1)[:, None, None]).astype(np.float32)


def test_iknet_from_flax_matches_jax(target):
    variables = j_fit.load_iknet_params(WEIGHTS)
    assert FROM_FLAX["IKNet"] is iknet_from_flax
    sd = t_fit.load_iknet_params(WEIGHTS)
    assert set(sd) == set(TIKNet().state_dict())
    net = TIKNet()
    net.load_state_dict(sd)
    net.eval()
    joints = _normalised(target)
    so3_j, quat_j = (np.asarray(a) for a in JIKNet().apply(variables, jnp.asarray(joints),
                                                            train=False))
    with torch.no_grad():
        so3_t, quat_t = net(torch.from_numpy(joints))
    np.testing.assert_allclose(quat_t.numpy(), quat_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(so3_t.numpy(), so3_j, atol=5e-5, rtol=0)
    rot_t = aa_to_rotmat(so3_t.reshape(B, 16, 3))
    rot_j = aa_to_rotmat(torch.tensor(so3_j).reshape(B, 16, 3))
    np.testing.assert_allclose(rot_t.numpy(), rot_j.numpy(), atol=1e-5, rtol=0)
    # the flat npz reader gives the flax tree the JAX loader gives
    flat = load_flax_npz(WEIGHTS)
    assert set(flat) == {"params", "batch_stats"}
    assert set(flat["params"]) == set(variables["params"])


def test_geo_prior_residual_and_gradient(models, target):
    """The residual of ``FittingUnit`` at the IKNet warm start, moved off it
    so the regularisers are not zero, and its gradient (the JAX side is
    ``fitting.py:116-128`` written out with the JAX package's functions)."""
    jm, tm = models
    unit = t_fit.FittingUnit(mano_model=tm, device="cpu")
    jt = torch.from_numpy(target)
    root, bone, joints_norm = unit._normalise(jt)
    so3_init = unit.init_pose(joints_norm)
    beta_init = torch.zeros((B, 10))
    rng = np.random.RandomState(1)
    so3 = (so3_init + torch.from_numpy(rng.randn(B, 48).astype(np.float32) * 0.05))
    beta = torch.from_numpy(rng.randn(B, 10).astype(np.float32) * 0.1)

    def j_residual(so3_, beta_):
        out = j_mano_forward(jm, so3_, beta_)
        j = out.joints - out.joints[:, 0:1]
        bone_pred = jnp.linalg.norm(j[:, 9] - j[:, 0] + 1e-8, axis=1, keepdims=True)[:, None]
        j_norm = j / jnp.maximum(bone_pred, 1e-8)
        reg = jnp.mean((so3_ - jnp.asarray(so3_init.numpy())) ** 2)
        reg_beta = jnp.mean(beta_ ** 2)
        errkp = jnp.mean((j_norm - jnp.asarray(joints_norm.numpy())) ** 2)
        j_abs = j_norm * jnp.asarray(bone.numpy()) + jnp.asarray(root.numpy())
        return 0.01 * reg + 0.01 * reg_beta + errkp + j_fit.geo_prior(j_abs)

    val_j, grads_j = jax.value_and_grad(j_residual, argnums=(0, 1))(
        jnp.asarray(so3.numpy()), jnp.asarray(beta.numpy()))
    params = [so3.clone().requires_grad_(True), beta.clone().requires_grad_(True)]
    val_t = unit.residual(*params, so3_init, beta_init, joints_norm, root, bone)
    grads_t = torch.autograd.grad(val_t, params)
    assert abs(float(val_t.detach()) - float(val_j)) <= 1e-6 * abs(float(val_j))
    for g_t, g_j in zip(grads_t, grads_j):
        g_j = np.asarray(g_j)
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-5 * np.linalg.norm(g_j)

    joints = target + rng.randn(*target.shape).astype(np.float32) * 0.01
    gp_j = float(j_fit.geo_prior(jnp.asarray(joints)))
    gp_t = float(t_fit.geo_prior(torch.from_numpy(joints)))
    assert gp_j > 0 and abs(gp_t - gp_j) <= 1e-6 * gp_j


def test_iknet_fit_matches_jax(models, target):
    jm, tm = models
    fitted_j = {k: np.asarray(v) for k, v in j_fit.FittingUnit(mano_model=jm)(target).items()}
    unit = t_fit.FittingUnit(mano_model=tm, device="cpu")
    assert unit.n_steps == 20
    fitted_t = unit(torch.from_numpy(target))
    for k, atol in (("joints", 5e-5), ("hand_verts", 5e-5), ("so3", 5e-4), ("beta", 5e-4)):
        np.testing.assert_allclose(fitted_t[k].numpy(), fitted_j[k], atol=atol, rtol=0, err_msg=k)
    err_fit = np.linalg.norm(fitted_t["joints"].numpy() - target, axis=-1).mean()
    warm = unit.warm_start(torch.from_numpy(target))
    err_init = np.linalg.norm(warm["joints"].numpy() - target, axis=-1).mean()
    assert err_fit < err_init * 0.9
    assert torch.isfinite(fitted_t["hand_verts"]).all()


def test_iksolver_fit(models, target):
    jm, tm = models
    short_j = j_fit.FittingUnit(mano_model=jm, ik_mode="iksolver", n_steps=20)(target)
    short_t = t_fit.FittingUnit(mano_model=tm, ik_mode="iksolver", n_steps=20,
                                device="cpu")(torch.from_numpy(target))
    for k, atol in (("joints", 5e-5), ("hand_verts", 5e-5), ("so3", 5e-4), ("beta", 5e-4)):
        np.testing.assert_allclose(short_t[k].numpy(), np.asarray(short_j[k]), atol=atol, rtol=0,
                                   err_msg=k)
    unit = t_fit.FittingUnit(mano_model=tm, ik_mode="iksolver", device="cpu")
    assert unit.n_steps == 100 and unit.iknet is None
    fitted_t = unit(torch.from_numpy(target))
    fitted_j = j_fit.FittingUnit(mano_model=jm, ik_mode="iksolver")(target)
    err_t = np.linalg.norm(fitted_t["joints"].numpy() - target, axis=-1).mean()
    err_j = np.linalg.norm(np.asarray(fitted_j["joints"]) - target, axis=-1).mean()
    flat = unit.warm_start(torch.from_numpy(target))
    np.testing.assert_array_equal(flat["so3"].numpy(), 0.0)
    err_init = np.linalg.norm(flat["joints"].numpy() - target, axis=-1).mean()
    assert err_t < err_init * 0.7 and err_j < err_init * 0.7
    assert abs(err_t - err_j) < 1e-3
    assert torch.isfinite(fitted_t["hand_verts"]).all()


def test_modes_and_missing_weights(models, monkeypatch, caplog):
    tm = models[1]
    with pytest.raises(ValueError):
        t_fit.FittingUnit(mano_model=tm, ik_mode="nonsense", device="cpu")
    monkeypatch.setattr(t_fit, "IKNET_WEIGHTS", "assets/no_such_iknet.npz")
    with caplog.at_level("WARNING", logger="artiboost_torch"):
        unit = t_fit.FittingUnit(mano_model=tm, device="cpu")
    assert any("RANDOM" in r.message for r in caplog.records)
    out = unit(torch.zeros((2, 21, 3)) + torch.linspace(0, 0.1, 21)[None, :, None])
    assert out["hand_verts"].shape == (2, 778, 3)
