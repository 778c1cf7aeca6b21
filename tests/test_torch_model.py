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


def test_bf16_forward_against_jax():
    """``ARCH.DTYPE: bfloat16`` in the port, at the sizes of tests/test_bf16.py
    (ResNet18, deconv 2 x 64, depth 8, 64 x 64 images, flax initialisation
    carried across): float32 outputs; the camera-space joints and corners
    within 5e-3 of the JAX float32 forward (the bound tests/test_bf16.py
    holds JAX's own bf16 to) and within 1e-2 of the JAX bf16 forward (both
    sides round to bf16 at different places). The 2D uvd output is held
    within 1e-2 of both: JAX's own bf16 moves it by 7.0e-3 from float32,
    more than 5e-3, through the box head's reprojected corners. Measured
    (port bf16): joints 9.7e-6 / 3.8e-6, corners 5.5e-4 / 3.0e-4, uvd
    5.3e-3 / 3.1e-3 against JAX float32 / bf16."""
    from tests.test_bf16 import ARCH_CFG, PRESET, _batch as bf16_batch

    batch = bf16_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j32 = j_build_arch(dict(ARCH_CFG), PRESET)
    j16 = j_build_arch({**ARCH_CFG, "DTYPE": "bfloat16"}, PRESET)
    variables = j32.init(jax.random.PRNGKey(0), jbatch, train=False)
    out32 = j32.apply(variables, jbatch, train=False)
    out16 = j16.apply(variables, jbatch, train=False)
    tarch = t_build_arch({**ARCH_CFG, "DTYPE": "bfloat16"}, PRESET).eval()
    tarch.model_list[0].load_state_dict(hybrid_baseline_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"]["model_list_0"],
                     "batch_stats": variables["batch_stats"]["model_list_0"]})))
    with torch.no_grad():
        tout = tarch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert tarch.model_list[0].backbone.conv1.compute_dtype == torch.bfloat16
    for k, bound32 in (("joints_3d_abs", 5e-3), ("corners_3d_abs", 5e-3), ("2d_uvd", 1e-2)):
        assert tout[k].dtype == torch.float32, k
        got = tout[k].numpy()
        assert np.abs(got - np.asarray(out32[k])).max() < bound32, k
        assert np.abs(got - np.asarray(out16[k])).max() < 1e-2, k
