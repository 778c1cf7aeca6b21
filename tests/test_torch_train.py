"""The port's train pass against the JAX package on the CPU: the criterions
(``artiboost_torch/criterions``), one train step, the optimizer and the
schedules (``parallel/train_state.py``). The slice as a whole is in
tests/test_torch_train_slice.py.

The ordinal losses' random view vectors and pair subsamples are injected
from the JAX side. The model starts from the flax initialisation carried
across by ``hybrid_baseline_from_flax``. Tolerances are stated in each
test."""
import numpy as np
import pytest
import torch

CFG_PATH = "config/synthetic_smoke.yaml"


def _half(rng, B, is_synth, with_mano=True):
    part = {
        "joints_3d": rng.randn(B, 21, 3).astype(np.float32) * 0.05,
        "corners_3d": rng.randn(B, 8, 3).astype(np.float32) * 0.05,
        "root_joint": (rng.randn(B, 3) * 0.01 + [0, 0, 0.5]).astype(np.float32),
        "joints_vis": (rng.rand(B, 21) > 0.2).astype(np.float32),
        "corners_vis": (rng.rand(B, 8) > 0.2).astype(np.float32),
        "is_synth": np.full((B,), is_synth, np.int32),
    }
    if with_mano:
        part["hand_pose"] = rng.randn(B, 48).astype(np.float32)
    return part


def jax_ordinal_draws(jax, k, loss):
    """The draws a JAX ordinal loss makes from its key (ordinal.py:88, :141)."""
    from artiboost_tpu.criterions.ordinal import _subsample_pairs, sample_view_vectors

    if type(loss).__name__ == "HandOrdLoss":
        k_view, k_j, k_p = jax.random.split(k, 3)
        return {"view": sample_view_vectors(k_view, loss.n_virtual_views),
                "sel_j": _subsample_pairs(k_j, loss.joint_pairs_idx.shape[0]),
                "sel_p": _subsample_pairs(k_p, loss.parts_pairs_idx.shape[0])}
    k_view, k_sel = jax.random.split(k)
    return {"view": sample_view_vectors(k_view, loss.n_virtual_views),
            "sel": _subsample_pairs(k_sel, loss.ho_pairs_idx.shape[0])}


def jax_loss_draws(jax, key, criterion):
    """The draws the JAX criterion makes from ``key`` (one split key per
    loss, criterion.py:55-58), in the port's per-loss layout."""
    out = []
    for loss, k in zip(criterion.loss_list, jax.random.split(key, len(criterion.loss_list))):
        ordinal = type(loss).__name__ in ("HandOrdLoss", "SceneOrdLoss")
        out.append(jax_ordinal_draws(jax, k, loss) if ordinal else {})
    return [{k: np.asarray(v) for k, v in d.items()} for d in out]


def to_torch_draws(draws):
    return [{k: torch.from_numpy(np.asarray(v).astype(np.int64) if np.asarray(v).dtype.kind == "i"
                                 else np.asarray(v)) for k, v in d.items()} for d in draws]


HAND_JOINTS = {"CRITERION": [{"TYPE": "HandJointsLoss", "LAMBDA_JOINTS_3D": 0.7}],
               "LAMBDAS": [1.0]}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("losses", ["config", "hand_joints"])
def test_losses_against_jax(losses, masked):
    """The config's JointsLoss, HandOrdLoss and SceneOrdLoss, or
    HandJointsLoss alone, on one mixed batch (real half without HAND_POSE
    and ROOT_JOINT when ``masked``, so KEY_VALID masks appear), with the JAX
    draws injected: every named loss within rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from artiboost_torch.criterions import build_criterion as t_build
    from artiboost_torch.utils.batching import union_concat as t_union
    from artiboost_torch.utils.config import load_config
    from artiboost_tpu.criterions import build_criterion as j_build
    from artiboost_tpu.utils.batching import union_concat as j_union

    cfg = load_config(CFG_PATH)
    if losses == "hand_joints":
        cfg.update(HAND_JOINTS)
    rng = np.random.RandomState(1)
    real, synth = _half(rng, 3, 0, with_mano=not masked), _half(rng, 5, 1)
    if masked:  # the real half also lacks the root: every loss folds its mask
        del real["root_joint"]
    preds = {"joints_3d_abs": rng.randn(8, 21, 3).astype(np.float32) * 0.05 + [0, 0, 0.5],
             "corners_3d_abs": rng.randn(8, 8, 3).astype(np.float32) * 0.05 + [0, 0, 0.5]}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    jbatch = j_union([{k: jnp.asarray(v) for k, v in p.items()} for p in (real, synth)])
    tbatch = t_union([{k: torch.from_numpy(v) for k, v in p.items()} for p in (real, synth)])
    assert ("_key_valid" in tbatch) == masked
    jcrit, tcrit = j_build(cfg), t_build(cfg)
    key = jax.random.PRNGKey(7)
    _, jl = jcrit.compute_losses({k: jnp.asarray(v) for k, v in preds.items()}, jbatch, key)
    _, tl = tcrit.compute_losses({k: torch.from_numpy(v) for k, v in preds.items()}, tbatch,
                                 to_torch_draws(jax_loss_draws(jax, key, jcrit)))
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=0, err_msg=k)
    assert float(tl["final_loss"]) > 0


def _model_batch(rng, B=4, S=64):
    intr = np.tile(np.asarray([[180.0, 0, 32], [0, 180.0, 32], [0, 0, 1]], np.float32), (B, 1, 1))
    b = _half(rng, B, 1)
    b.update({"image": (rng.rand(B, S, S, 3) - 0.5).astype(np.float32), "cam_intr": intr,
              "corners_can": (rng.randn(B, 8, 3) * 0.05).astype(np.float32)})
    return b


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_step_against_jax():
    """One train step of the config's HybridBaseline (float32, 64 x 64) from
    the same flax initialisation and batch: every loss within rtol 1e-5;
    each gradient tensor within 1e-4 of its norm; each BatchNorm running
    statistic after the step within 1e-5 of its norm (flax's update:
    momentum 0.9, the biased batch variance; the means of near-zero
    channels sum 1024 values in another order)."""
    import jax
    import jax.numpy as jnp

    from artiboost_torch.criterions import build_criterion as t_build
    from artiboost_torch.models.arch import build_arch as t_arch
    from artiboost_torch.parallel.train_state import TrainStep
    from artiboost_torch.utils.config import load_config
    from artiboost_torch.utils.convert import hybrid_baseline_from_flax, hybrid_baseline_to_flax
    from artiboost_tpu.criterions import build_criterion as j_build
    from artiboost_tpu.models import build_arch as j_arch

    cfg = load_config(CFG_PATH)
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[64, 64])
    batch = _model_batch(np.random.RandomState(2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jarch, jcrit = j_arch(cfg["ARCH"], preset), j_build(cfg)
    variables = jax.jit(lambda k, b: jarch.init(k, b, train=True))(jax.random.PRNGKey(3), jb)
    key = jax.random.PRNGKey(4)

    def loss_fn(params):
        preds, mut = jarch.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 jb, train=True, mutable=["batch_stats"])
        total, losses = jcrit.compute_losses(preds, jb, key)
        return total, (losses, mut["batch_stats"])

    (_, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    hb = lambda tree: jax.tree_util.tree_map(np.asarray, tree["model_list_0"])

    tarch = t_arch(cfg["ARCH"], preset)
    tarch.model_list[0].load_state_dict(hybrid_baseline_from_flax(
        {"params": hb(variables["params"]), "batch_stats": hb(variables["batch_stats"])}))
    step = TrainStep(tarch, t_build(cfg), cfg["TRAIN"], device="cpu")
    _, tlosses = step.forward_backward({k: torch.from_numpy(v) for k, v in batch.items()},
                                       to_torch_draws(jax_loss_draws(jax, key, jcrit)))
    for k in jlosses:
        np.testing.assert_allclose(float(tlosses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    prefix = "model_list.0."
    grads = hybrid_baseline_to_flax({n[len(prefix):]: p.grad for n, p in tarch.named_parameters()})
    ref = jax.tree_util.tree_leaves_with_path(hb(jgrads))
    got = dict(jax.tree_util.tree_leaves_with_path(grads["params"]))
    assert len(got) == len(ref)
    worst = max(_rel_err(got[p], g) for p, g in ref)
    assert worst <= 1e-4, worst
    stats = hybrid_baseline_to_flax(dict(tarch.model_list[0].named_buffers()))["batch_stats"]
    got = dict(jax.tree_util.tree_leaves_with_path(stats))
    worst = max(_rel_err(got[p], v) for p, v in jax.tree_util.tree_leaves_with_path(hb(jstats)))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
def test_optimizer_against_optax(opt):
    """The optimizer alone on identical gradients, 3 steps, with the config's
    GRAD_CLIP 0.001 (every step clips): params within atol 1e-7 of optax's
    chain(clip_by_global_norm, adam | adamw under the decay mask | sgd)."""
    import jax.numpy as jnp
    import optax

    from artiboost_tpu.parallel.train_state import build_optimizer as j_build_opt
    from artiboost_torch.parallel.train_state import TrainStep

    rng = np.random.RandomState(5)
    train_cfg = {"OPTIMIZER": "sgd" if opt == "sgd" else "adam", "LR": 1e-3, "GRAD_CLIP": 0.001,
                 "WEIGHT_DECAY": 0.01 if opt == "adamw" else 0.0, "MOMENTUM": 0.9}
    model = torch.nn.Module()
    # weights at an initialisation's scale, where one float32 ulp is < 3e-8
    model.w = torch.nn.Parameter(torch.from_numpy(rng.randn(5, 4).astype(np.float32) * 0.1))
    model.regressor = torch.nn.Parameter(torch.from_numpy(rng.randn(3).astype(np.float32) * 0.1))
    step = TrainStep(model, criterion=None, train_cfg=train_cfg, device="cpu")
    jopt, _ = j_build_opt(train_cfg)
    params = {"w": jnp.asarray(model.w.detach().numpy().copy()),
              "regressor": jnp.asarray(model.regressor.detach().numpy().copy())}
    state = jopt.init(params)
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) * 0.01 for k, v in params.items()}
        model.w.grad, model.regressor.grad = torch.from_numpy(g["w"]), torch.from_numpy(g["regressor"])
        step.update()
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)
        for k in params:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(params[k]),
                                       atol=1e-7, rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", ["step", "cosine", "linear"])
def test_scheduler_against_optax(kind):
    """The learning rate at each update count matches the JAX package's
    optax schedule: rtol 1e-6, atol 1e-9 (1e-6 of the base rate; optax
    evaluates in float32, the port in double)."""
    from artiboost_torch.parallel.train_state import build_scheduler as t_sched
    from artiboost_tpu.parallel.train_state import build_scheduler as j_sched

    cfg = {"SCHEDULER": kind, "LR_DECAY_STEP": 7, "LR_DECAY_GAMMA": 0.5, "TOTAL_STEPS": 40,
           "WARMUP_STEPS": 5}
    ts, js = t_sched(cfg, 1e-3), j_sched(cfg, 1e-3)
    for s in (0, 1, 4, 5, 6, 7, 13, 14, 22, 39, 40, 55):
        np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6, atol=1e-9, err_msg=str(s))


@pytest.mark.parametrize("kind", ["dataset", "loss"])
def test_unported_type_raises_with_its_name(kind, tmp_path):
    """A DATASET.TRAIN or CRITERION type that no registry knows raises
    ``KeyError`` with its name and the registry's, as JAX's
    ``build_from_cfg`` does; the train pass does not skip it. (A real-data type whose data is
    absent raises FileNotFoundError instead, as the JAX package's does:
    tests/test_torch_entry.py.) Every dataset and loss of the JAX package is
    ported, so both cases name a type that neither package knows; the
    dataset's data directory exists, so the name is what raises."""
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.datasets.synthetic import build_dataset

    (tmp_path / "HO3D" / "train").mkdir(parents=True)
    with pytest.raises(KeyError, match="NoSuchDataset is not in the dataset registry|"
                                       "NoSuchLoss is not in the loss registry"):
        if kind == "dataset":
            build_dataset({"TYPE": "NoSuchDataset", "DATA_SPLIT": "train",
                           "DATA_ROOT": str(tmp_path)}, {}, device="cpu")
        else:
            build_criterion({"CRITERION": [{"TYPE": "NoSuchLoss"}], "LAMBDAS": [1.0]})
