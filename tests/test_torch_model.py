"""HybridBaseline forward of the port (eval mode, float32) against the
flax model, with the weights carried across by
``artiboost_torch.utils.convert.hybrid_baseline_from_flax``.

Small size: ResNet18 with a narrow head (config/synthetic_smoke.yaml's
ARCH: deconv 2 x 128, depth 16, box MLP [512, 128]) on 64 x 64 images;
BatchNorm statistics are randomized so the conversion of batch_stats is
exercised. Tolerance rtol = atol = 1e-4 as in tests/test_full_parity.py
(float32 convolutions summed in another order), and 2e-6 m on the
camera-space joints and corners that the per-triplet EPE reads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import hybrid_baseline_from_flax
from artiboost_tpu.models import build_arch as j_build_arch

TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:  # var
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    return out


def _batch(rng, B=3, S=64):
    intr = np.tile(np.asarray([[180.0, 0, 32], [0, 180.0, 32], [0, 0, 1]], np.float32), (B, 1, 1))
    return {"image": (rng.rand(B, S, S, 3) - 0.5).astype(np.float32),
            "root_joint": (rng.randn(B, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
            "cam_intr": intr,
            "corners_can": (rng.randn(B, 8, 3) * 0.05).astype(np.float32)}


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_baseline_forward(seed):
    cfg = load_config("config/synthetic_smoke.yaml")
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[64, 64])
    rng = np.random.RandomState(seed)
    batch = _batch(rng)
    jarch = j_build_arch(cfg["ARCH"], preset)
    variables = jarch.init(jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()},
                           train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _randomize_stats(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]), rng)
    jout = jarch.apply({"params": params, "batch_stats": stats},
                       {k: jnp.asarray(v) for k, v in batch.items()}, train=False)

    tarch = t_build_arch(cfg["ARCH"], preset).eval()
    tarch.model_list[0].load_state_dict(hybrid_baseline_from_flax(
        {"params": params["model_list_0"], "batch_stats": stats["model_list_0"]}))
    with torch.no_grad():
        tout = tarch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), err_msg=k, **TOL)
    # the camera-space outputs the val metric reads, in metres: from the
    # same inputs they agree to 2e-3 mm
    for k in ("joints_3d_abs", "corners_3d_abs"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=2e-6, rtol=0,
                                   err_msg=k)
