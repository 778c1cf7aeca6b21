"""The Reg and HoNet model families of the port against the JAX package on
the CPU: ``pca_to_axisang``, ``rotmat_proj``, ManoBranch in PCA and rotmat
modes, and the HOPRegNet, HoNet (with and without the FHB adaptor) and
SimpleBaseline forwards from the flax initialisation carried across by
``artiboost_torch.utils.convert``; the frozen ManoAdaptor regressor under
AdamW with weight decay.

Small size: ResNet18 on 64 x 64 images, batch 3, BatchNorm statistics
randomised so their conversion is exercised. Tolerances:
  * ``pca_to_axisang``: rtol 1e-5 (atol 1e-7): ``coeffs @
    hands_components`` sums in another order in XLA and in torch;
  * ``rotmat_proj``: the projected matrix at atol 1e-5, not u or vt, whose
    signs are each solver's own (6e-5 for matrices near -I, whose nearly
    equal singular values leave both solvers 1.86e-5 from float64; 1.87e-5
    measured between them); it is a rotation to 1e-5;
  * float32 forwards: the camera-space joints, vertices and corners at
    atol 1e-5 m (sin/cos in FK differ in the last bit, ROADMAP C); every
    other output at rtol 1e-4 plus atol 1e-4 (the pixel projections at
    atol 2e-3 px), as tests/test_torch_model.py holds HybridBaseline;
  * bf16 ``ARCH.DTYPE`` (the backbone alone in bf16, the heads and FK in
    float32, as the JAX build functions do): the camera-space outputs within
    5e-3 of the JAX bf16 forward, the HybridBaseline precedent.
Measured here: float32 joints and vertices within 1.5e-7 m, corners and
object vertices within 3.8e-7 m; bf16 joints and vertices within 5.7e-4,
corners within 2.95e-3 (HOPRegNet's object head reads the bf16 feature)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.mano import layer as t_layer
from artiboost_torch.mano import model as t_model
from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.utils import transform as t_tf
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import FROM_FLAX
from artiboost_tpu.mano import layer as j_layer
from artiboost_tpu.mano import model as j_model
from artiboost_tpu.models import build_arch as j_build_arch
from artiboost_tpu.utils import transform as j_tf
from tests.test_torch_model import _randomize_stats

S, B = 64, 3
REG = "config/synthetic_smoke_reg.yaml"
HONET = "config/synthetic_smoke_honet.yaml"
CAMERA_SPACE = ("joints_3d_abs", "joints_3d", "hand_verts_3d_abs", "hand_verts_3d",
                "corners_3d_abs", "corners_3d", "obj_verts_3d_abs", "obj_verts_3d",
                "boxroot_3d_abs", "obj_center", "root_joint")


def _batch(rng):
    intr = np.tile(np.asarray([[180.0, 0, 32], [0, 180.0, 30], [0, 0, 1]], np.float32), (B, 1, 1))
    return {"image": (rng.rand(B, S, S + 8, 3) - 0.5).astype(np.float32),
            "root_joint": (rng.randn(B, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
            "cam_intr": intr,
            "corners_can": (rng.randn(B, 8, 3) * 0.05).astype(np.float32),
            "obj_verts_can": (rng.randn(B, 40, 3) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def manos():
    return j_model.synthetic_mano_model(), t_model.synthetic_mano_model(device="cpu")


@pytest.mark.parametrize("flat_hand_mean", [True, False])
def test_pca_to_axisang(manos, flat_hand_mean):
    jm, tm = manos
    # a hands_mean that is not zero, so flat_hand_mean matters
    mean = np.random.RandomState(5).randn(45).astype(np.float32) * 0.1
    jm, tm = jm._replace(hands_mean=jnp.asarray(mean)), tm._replace(hands_mean=torch.from_numpy(mean))
    coeffs = np.random.RandomState(0).randn(5, 18).astype(np.float32)
    want = np.asarray(j_layer.pca_to_axisang(jm, jnp.asarray(coeffs), 15, flat_hand_mean))
    got = t_layer.pca_to_axisang(tm, torch.from_numpy(coeffs), 15, flat_hand_mean).numpy()
    assert got.shape == (5, 48)
    np.testing.assert_array_equal(got[:, :3], coeffs[:, :3])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_rotmat_proj():
    rng = np.random.RandomState(2)
    m = rng.randn(64, 3, 3).astype(np.float32)
    m[:8] = -np.eye(3, dtype=np.float32) + 0.01 * m[:8]  # det < 0: the sign fix applies
    want = np.asarray(j_tf.rotmat_proj(jnp.asarray(m)))
    got = t_tf.rotmat_proj(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got[8:], want[8:], atol=1e-5, rtol=0)
    # near -I the three singular values are nearly equal and the sign fix
    # hinges on which is least: both solvers sit 1.86e-5 from float64 there
    np.testing.assert_allclose(got[:8], want[:8], atol=6e-5, rtol=0)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (64, 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def _models(arch_cfg, preset, batch, seed=0):
    """(JAX arch, its float32 variables with random statistics, the port's
    arch with them loaded) at the batch's image size."""
    jarch = j_build_arch(arch_cfg, preset)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jarch.init(jax.random.PRNGKey(seed), jb, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _randomize_stats(jax.tree_util.tree_map(np.asarray, variables["batch_stats"]),
                             np.random.RandomState(seed))
    tarch = t_build_arch(arch_cfg, preset).eval()
    tarch.model_list[0].load_state_dict(FROM_FLAX[arch_cfg["TYPE"]](
        {"params": params["model_list_0"], "batch_stats": stats["model_list_0"]}))
    return jarch, {"params": params, "batch_stats": stats}, tarch


def _forward(arch_cfg, preset, seed=0):
    batch = _batch(np.random.RandomState(seed))
    jarch, variables, tarch = _models(arch_cfg, preset, batch, seed)
    jout = jarch.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.no_grad():
        tout = tarch({k: torch.from_numpy(v) for k, v in batch.items()})
    return jout, tout, tarch


def _hold(jout, tout):
    assert set(tout) == set(jout)
    for k in jout:
        got, want = tout[k].numpy(), np.asarray(jout[k])
        assert tout[k].dtype == torch.float32, k
        if k in CAMERA_SPACE:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=k)
        elif k.endswith("_2d"):
            np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)


def _arch(path, **extra):
    cfg = load_config(path)
    return dict(cfg["ARCH"], **extra), dict(cfg["DATA_PRESET"], IMAGE_SIZE=[S, S + 8])


@pytest.mark.parametrize("use_pca", [True, False])
def test_hopregnet_forward(use_pca):
    """HOPRegNet with ManoBranch in PCA mode (config/synthetic_smoke_reg.yaml)
    and in rotmat mode (16 x 9 outputs through ``rotmat_proj``; the
    axis-angle pose reported detached, as JAX's stop_gradient)."""
    arch, preset = _arch(REG)
    arch["HEAD"] = dict(arch["HEAD"], USE_PCA=use_pca)
    jout, tout, tarch = _forward(arch, preset)
    _hold(jout, tout)
    branch = tarch.model_list[0].mano_branch
    assert branch.pose.out_features == (18 if use_pca else 144)
    assert not tout["mano_full_pose"].requires_grad


def test_mano_branch_without_shape():
    arch, preset = _arch(REG)
    arch["HEAD"] = dict(arch["HEAD"], USE_SHAPE=False)
    jout, tout, tarch = _forward(arch, preset, seed=1)
    _hold(jout, tout)
    assert tarch.model_list[0].mano_branch.shape is None
    assert not tout["mano_shape"].any()


@pytest.mark.parametrize("adaptor", [False, True])
def test_honet_forward(adaptor):
    """HoNet (config/synthetic_smoke_honet.yaml) on a non-square image, so
    ``recover_3d_proj`` reads the width and height from the right axes;
    with MANO_FHB_ADAPTOR its joints come from the frozen regressor."""
    arch, preset = _arch(HONET, MANO_FHB_ADAPTOR=adaptor)
    jout, tout, tarch = _forward(arch, preset, seed=2)
    _hold(jout, tout)
    assert (tarch.model_list[0].adaptor is not None) == adaptor
    assert "obj_verts_3d_abs" in tout


def test_honet_without_object_vertices():
    arch, preset = _arch(HONET)
    batch = _batch(np.random.RandomState(3))
    del batch["obj_verts_can"]
    jarch, variables, tarch = _models(arch, preset, batch, 3)
    jout = jarch.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    with torch.no_grad():
        tout = tarch({k: torch.from_numpy(v) for k, v in batch.items()})
    _hold(jout, tout)
    assert "obj_verts_3d_abs" not in tout


def test_simple_baseline_forward():
    """SimpleBaseline over 29 keypoints with config/synthetic_smoke.yaml's
    narrow integral head."""
    cfg = load_config("config/synthetic_smoke.yaml")
    arch = {"TYPE": "SimpleBaseline", "BACKBONE": {"TYPE": "ResNet18"},
            "HEAD": dict(cfg["ARCH"]["HYBRID_HEAD"], NCLASSES=29)}
    jout, tout, _ = _forward(arch, dict(cfg["DATA_PRESET"], IMAGE_SIZE=[S, S + 8]), seed=4)
    _hold(jout, tout)


@pytest.mark.parametrize("path", [REG, HONET])
def test_bf16_forward(path):
    """``ARCH.DTYPE: bfloat16``: the port's backbone computes in bf16 and its
    heads in float32, as the JAX build functions give the DTYPE to the
    backbone alone; camera-space outputs within 5e-3 of JAX's bf16 forward."""
    arch, preset = _arch(path, DTYPE="bfloat16")
    jout, tout, tarch = _forward(arch, preset, seed=5)
    model = tarch.model_list[0]
    assert model.backbone.conv1.compute_dtype == torch.bfloat16
    assert model.mano_branch.fc1.compute_dtype == torch.float32
    assert set(tout) == set(jout)
    for k in CAMERA_SPACE:
        if k in jout:
            assert tout[k].dtype == torch.float32, k
            assert np.abs(tout[k].numpy() - np.asarray(jout[k])).max() < 5e-3, k


def test_adaptor_regressor_frozen_under_adamw():
    """The frozen regressor under AdamW with weight decay, mirroring
    tests/test_models.py:203: ``_decay_mask`` keeps decay off a parameter
    named ``regressor`` with zero gradients while another decays; in HoNet
    the regressor has requires_grad False, so a train step leaves it
    bit-equal while the heads move."""
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.parallel.train_state import TrainStep, build_optimizer

    reg = torch.nn.Parameter(torch.ones(4, 4))
    dense = torch.nn.Parameter(torch.ones(4, 4))
    opt, _ = build_optimizer({"OPTIMIZER": "adam", "LR": 1e-2, "WEIGHT_DECAY": 0.1},
                             [("adaptor.regressor", reg), ("dense.weight", dense)])
    reg.grad, dense.grad = torch.zeros_like(reg), torch.zeros_like(dense)
    opt.step()
    assert torch.equal(reg.detach(), torch.ones(4, 4))
    assert float((dense.detach() - 1.0).abs().max()) > 0

    arch, preset = _arch(HONET, MANO_FHB_ADAPTOR=True)
    model = t_build_arch(arch, preset)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, build_criterion({"CRITERION": [
        {"TYPE": "ManoLoss", "LAMBDA_JOINTS_3D": 1.0, "LAMBDA_SHAPE_REG": 1.0}],
        "LAMBDAS": [1.0]}), {"OPTIMIZER": "adam", "LR": 1e-2, "WEIGHT_DECAY": 0.1}, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.RandomState(6)).items()}
    batch["joints_3d"] = torch.randn(B, 21, 3) * 0.05
    step(batch, [{}])
    after = dict(model.named_parameters())
    name = "model_list.0.adaptor.regressor"
    assert not after[name].requires_grad and name not in dict(step.named_params)
    assert torch.equal(after[name].detach(), before[name])
    assert not torch.equal(after["model_list.0.mano_branch.fc1.weight"].detach(),
                           before["model_list.0.mano_branch.fc1.weight"])


def _train_batch(rng, B=4, V=40):
    """A synth-schema batch carrying every key the Reg and HoNet criterions
    read (tests/test_torch_train.py's, plus the MANO and object vertices)."""
    from tests.test_torch_train import _model_batch

    b = _model_batch(rng, B=B, S=S)
    b.update(hand_verts_3d=(rng.randn(B, 778, 3) * 0.05).astype(np.float32),
             obj_verts_can=(rng.randn(B, V, 3) * 0.05).astype(np.float32),
             obj_verts_3d=(rng.randn(B, V, 3) * 0.05).astype(np.float32),
             padding_mask=(rng.rand(B, V) > 0.2).astype(np.float32))
    return b


@pytest.mark.parametrize("path", [REG, HONET])
def test_train_step_gradients(path):
    """One forward and backward of the config's model and criterion
    (float32, 64 x 64, train-mode BatchNorm) from the same flax
    initialisation, batch and ordinal draws: every loss within rtol 1e-5
    and each gradient tensor within 1e-4 of its norm, as
    tests/test_torch_train.py holds HybridBaseline. The JAX gradients are
    carried into torch's names and layouts by the model's ``*_from_flax``."""
    from artiboost_torch.criterions import build_criterion as t_crit
    from artiboost_torch.parallel.train_state import TrainStep
    from artiboost_tpu.criterions import build_criterion as j_crit
    from tests.test_torch_train import _rel_err, jax_loss_draws, to_torch_draws

    cfg = load_config(path)
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[S, S])
    batch = _train_batch(np.random.RandomState(8))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jarch, jcrit = j_build_arch(cfg["ARCH"], preset), j_crit(cfg)
    variables = jax.jit(lambda k, b: jarch.init(k, b, train=True))(jax.random.PRNGKey(9), jb)
    key = jax.random.PRNGKey(10)

    def loss_fn(params):
        preds, _ = jarch.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jb, train=True, mutable=["batch_stats"])
        return jcrit.compute_losses(preds, jb, key)

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    m0 = lambda tree: jax.tree_util.tree_map(np.asarray, tree["model_list_0"])  # noqa: E731
    convert = FROM_FLAX[cfg["ARCH"]["TYPE"]]
    tarch = t_build_arch(cfg["ARCH"], preset)
    tarch.model_list[0].load_state_dict(convert({"params": m0(variables["params"]),
                                                 "batch_stats": m0(variables["batch_stats"])}))
    step = TrainStep(tarch, t_crit(cfg), cfg["TRAIN"], device="cpu")
    _, tlosses = step.forward_backward({k: torch.from_numpy(v) for k, v in batch.items()},
                                       to_torch_draws(jax_loss_draws(jax, key, jcrit)))
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(tlosses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    want = convert({"params": m0(jgrads), "batch_stats": m0(variables["batch_stats"])})
    got = {n[len("model_list.0."):]: p.grad for n, p in tarch.named_parameters()
           if p.requires_grad}
    assert sorted(got) == sorted(k for k in want if not k.endswith(("running_mean", "running_var",
                                                                    "num_batches_tracked")))
    worst = max(_rel_err(got[k].numpy(), want[k].numpy()) for k in got)
    assert worst <= 1e-4, worst

