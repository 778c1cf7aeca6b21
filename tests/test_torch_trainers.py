"""The RefineNet and IKNet trainers of the port against the JAX package's
``make_refiner_train_step`` and ``make_iknet_train_step``: from the flax
initialisation, converted, with JAX's draws injected, 1 and 5 steps on the
same batches; ``save_refiner_params`` / ``save_iknet_params`` read back by
the JAX package's loaders; IKNet's repaired BatchNorm; both scripts'
``main`` on the CPU.

JAX's gradients are read from Adam's first moment after one step
(mu = (1 - b1) g). Tolerances (measured in brackets):
- one step: the loss terms within 1e-5 relative (4.0e-7 refiner, 2.6e-7
  IKNet), the gradients within 1e-3 of their global norm (1.6e-6, 8.0e-6),
  99 % of the parameters within 1e-6 (100 %, 99.85 %); FK runs through
  XLA's and torch's sin/cos, which differ in the last bit (ROADMAP C);
- every parameter within 2 lr a step: Adam's step is about lr whatever
  the gradient's size, so float noise in a gradient near 0 flips it.
  IKNet's Dense biases before each BatchNorm have a gradient of exactly 0
  (BatchNorm removes any shift), so Adam turns their float noise into
  steps of +-lr (the 0.15 % of its parameters beyond 1e-6 after one step);
- the refiner after 5 steps (lr 1e-4): each step's loss terms within
  1e-4 (1.5e-5), 99 % of the parameters within 1e-6 (99.997 %);
- IKNet after 5 steps (lr 1e-3, every weight moved by about lr a step):
  the departure grows about five-fold a step (2.6e-7, 3.0e-6, 6.0e-5,
  3.3e-4, 1.3e-3 on the loss), so the fifth step's loss terms within
  5e-3 and 95 % of the parameters within 1e-4 (97.6 %);
- IKNet's BatchNorm running statistics (flax's biased update) after one
  step within 1e-5 relative plus 1e-6 (1.2e-7 on the variances: torch's
  unbiased update departs by 1/255 at B = 256, which this refuses); after
  5 steps the variances within 1e-2 relative (4.4e-3) and the means within
  3e-3 (1.7e-3: the running means carry the noise-driven biases above,
  0.1 of 2 lr a step);
- the saved npz bit for bit, both ways.

JAX's steps run jitted, each trainer's in a thread beside the port's
steps."""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.artiboost import refiner as t_ref
from artiboost_torch.artiboost.grasp_library import synthetic_grasp_library
from artiboost_torch.artiboost.object_library import synthetic_object_library
from artiboost_torch.artiboost.scrambler import Scrambler
from artiboost_torch.mano.model import synthetic_mano_model
from artiboost_torch.postprocess import fitting as t_fit
from artiboost_torch.postprocess.iknet import IKNet as TIKNet
from artiboost_torch.scripts import train_iknet, train_refiner
from artiboost_torch.utils.convert import (iknet_from_flax, iknet_to_flax, refinenet_from_flax,
                                           refinenet_to_flax)
from artiboost_tpu.artiboost import refiner as j_ref
from artiboost_tpu.artiboost.grasp_library import synthetic_grasp_library as j_grasps
from artiboost_tpu.artiboost.object_library import synthetic_object_library as j_objs
from artiboost_tpu.artiboost.scrambler import build_scrambler
from artiboost_tpu.mano.model import synthetic_mano_model as j_mano
from artiboost_tpu.postprocess import fitting as j_fit
from artiboost_tpu.postprocess.iknet import IKNet as JIKNet

OBJS = ["o0", "o1", "o2", "o3"]
SCRAM = {"TYPE": "random_2", "HAND_POSE_SIGMA": 0.3, "HAND_TSL_SIGMA": 0.02}
B_REF, M_REF, REF_ITERS, N_STEPS = 4, 64, 2, 5
REF_LR, IK_LR = 1e-4, 1e-3
t_mano = partial(synthetic_mano_model, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _jax_grads(opt_state, params) -> dict:
    """One optax.adam step's gradients: mu = (1 - b1) g after the first."""
    mu = opt_state[0].mu
    return _flat(jax.tree_util.tree_map(lambda m: m / (1.0 - 0.9), mu))


def _hold_step(t_loss, j_metrics, keys, rtol):
    for k in keys:
        np.testing.assert_allclose(float(t_loss[k]), float(j_metrics[k]), rtol=rtol, err_msg=k)


def _hold_grads(t_grads: dict, j_grads: dict):
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in j_grads.values()))
    errs = {k: float(np.linalg.norm(t_grads[k] - jg)) / norm for k, jg in j_grads.items()}
    assert np.sqrt(sum(e * e for e in errs.values())) <= 1e-3, errs


def _hold_params(t_flat: dict, j_flat: dict, lr: float, steps: int, within: float,
                 share: float):
    """Every parameter within 2 lr a step, ``share`` of them within ``within``."""
    diffs = np.concatenate([np.abs(t_flat[k] - v).ravel() for k, v in j_flat.items()])
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert (diffs <= within).mean() >= share, (diffs <= within).mean()


# ---------------------------------------------------------------- refiner
def _refiner_draws(key, B):
    """The draws of JAX's loss_fn for one key: the rotation's axis and
    angle, then random_2's (``split(k_scram, 4)``)."""
    k_rot, k_scram = jax.random.split(key)
    ks = jax.random.split(k_scram, 4)
    return {"axis": _t(jax.random.normal(k_rot, (B, 3))),
            "angle": _t(jax.random.uniform(jax.random.fold_in(k_rot, 1), (B, 1),
                                           minval=0.0, maxval=2.0 * jnp.pi)),
            "scram": {k: _t(jax.random.normal(kk, (B, n))) for k, kk, n in (
                ("tsl", ks[0], 3), ("splay", ks[1], 4), ("bend", ks[2], 5), ("other", ks[3], 2))}}


def _jax_loop(step_fn, state, args_of_step):
    """JAX's steps -> (metrics per step, gradients of the first, state after
    the first, state after the last), on numpy."""
    out = {"metrics": []}
    params, opt_state = state
    for s in range(N_STEPS):
        params, opt_state, met = step_fn(params, opt_state, *args_of_step(s))
        out["metrics"].append({k: float(v) for k, v in met.items()})
        if s == 0:
            out["grads"] = _jax_grads(opt_state, params)
            out["first"] = _flat(jax.device_get(params))
    out["last"] = _flat(jax.device_get(params))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Both JAX trainers, from their flax init (jitted), each stepped N_STEPS
    times in a thread of its own while the tests run the port's steps: XLA
    compiles outside the GIL, and the compiles are most of the time."""
    jm = j_mano()
    jo, jg = j_objs(OBJS), j_grasps(len(OBJS), 8)
    rng = np.random.RandomState(4)
    sel = np.sort(rng.choice(jo.verts.shape[1], M_REF, replace=False))
    batches = [(rng.randint(0, len(OBJS), B_REF), rng.randint(0, 8, B_REF))
               for _ in range(N_STEPS)]
    ref_init, ref_step = j_ref.make_refiner_train_step(
        jm, j_ref.RefineNet(), build_scrambler(SCRAM), n_iters=REF_ITERS, learning_rate=REF_LR)
    ik_init, ik_step = j_fit.make_iknet_train_step(jm, JIKNet(), learning_rate=IK_LR)
    ref_state = jax.jit(ref_init)(jax.random.PRNGKey(0))
    ik_state = jax.jit(ik_init)(jax.random.PRNGKey(0))

    def ref_args(s):
        oid, gid = batches[s]
        return (jax.random.PRNGKey(100 + s), *jg.gather(jnp.asarray(oid), jnp.asarray(gid)),
                jo.verts[oid][:, sel], jo.vert_valid[oid][:, sel])

    with ThreadPoolExecutor(2) as pool:
        futures = {"refiner": pool.submit(_jax_loop, ref_step, ref_state, ref_args),
                   "iknet": pool.submit(_jax_loop, ik_step, ik_state,
                                        lambda s: (jax.random.PRNGKey(200 + s),))}
        yield {"refiner": (jax.device_get(ref_state[0]), batches, sel),
               "iknet": jax.device_get(ik_state[0]), "futures": futures}


@pytest.fixture(scope="module")
def refiner_run(jax_runs):
    init, batches, sel = jax_runs["refiner"]
    to = synthetic_object_library(OBJS, device="cpu")
    tg = synthetic_grasp_library(len(OBJS), 8, device="cpu")
    t_net = t_ref.RefineNet()
    t_net.load_state_dict(refinenet_from_flax(init["params"]))
    t_step = t_ref.RefinerTrainStep(t_mano(), t_net, Scrambler(SCRAM), n_iters=REF_ITERS,
                                    learning_rate=REF_LR)
    out = {"t": []}
    for s, (oid, gid) in enumerate(batches):
        tp = tg.gather(torch.from_numpy(oid), torch.from_numpy(gid))
        out["t"].append(t_step(_refiner_draws(jax.random.PRNGKey(100 + s), B_REF), *tp,
                               to.verts[oid][:, sel], to.vert_valid[oid][:, sel]))
        if s == 0:
            out["t_grads"] = _flat({"params": refinenet_to_flax(
                {k: p.grad for k, p in t_net.named_parameters()})})
            out["t_first"] = _flat(refinenet_to_flax(t_net.state_dict()))
    out["t_last"] = _flat(refinenet_to_flax(t_net.state_dict()))
    j = jax_runs["futures"]["refiner"].result()
    strip = lambda flat: {k[len("params/"):]: v for k, v in flat.items()}  # noqa: E731
    out.update(j=j["metrics"], j_grads=j["grads"], first=(strip(j["first"]), out["t_first"]),
               last=(strip(j["last"]), out["t_last"]), net=t_net, params_keys=sorted(j["last"]))
    return out


def test_refiner_step_against_jax(refiner_run):
    r = refiner_run
    keys = ("loss", "l_verts", "l_joints", "l_contact")
    _hold_step(r["t"][0], r["j"][0], keys, 1e-5)
    _hold_grads(r["t_grads"], r["j_grads"])
    _hold_params(r["first"][1], r["first"][0], REF_LR, 1, 1e-6, 0.99)
    for t, j in zip(r["t"][1:], r["j"][1:]):
        _hold_step(t, j, keys, 1e-4)
    _hold_params(r["last"][1], r["last"][0], REF_LR, N_STEPS, 1e-6, 0.99)
    assert all(np.isfinite(float(m["loss"])) for m in r["t"])


def test_save_refiner_params_loads_in_jax(refiner_run, tmp_path):
    path = str(tmp_path / "refinenet.npz")
    t_ref.save_refiner_params(refiner_run["net"], path)
    loaded = _flat(jax.device_get(j_ref.load_refiner_params(path)))
    want = _flat({"params": refinenet_to_flax(refiner_run["net"].state_dict())})
    assert sorted(loaded) == sorted(want) == refiner_run["params_keys"]
    for k, v in want.items():
        assert loaded[k].dtype == v.dtype and np.array_equal(loaded[k], v), k
    back = refinenet_from_flax(jax.device_get(j_ref.load_refiner_params(path))["params"])
    for k, v in refiner_run["net"].state_dict().items():
        assert torch.equal(back[k], v), k
    net = t_ref.build_refiner({"TYPE": "hand_obj", "PRETRAINED": path}, t_mano(), device="cpu")
    assert callable(net)


# ---------------------------------------------------------------- IKNet
def _iknet_draws(key, B=256):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"pose": _t(jax.random.normal(k1, (B, 48))),
            "shape": _t(jax.random.normal(k2, (B, 10))),
            "sigma": _t(jax.random.uniform(k3, (B, 1), minval=0.05, maxval=0.5))}


@pytest.fixture(scope="module")
def iknet_run(jax_runs):
    t_net = TIKNet()
    t_net.load_state_dict(iknet_from_flax(jax_runs["iknet"]))
    t_step = t_fit.IKNetTrainStep(t_mano(), t_net, learning_rate=IK_LR)
    out = {"t": []}
    for s in range(N_STEPS):
        out["t"].append(t_step(_iknet_draws(jax.random.PRNGKey(200 + s))))
        if s == 0:
            grads = {k: p.grad for k, p in t_net.named_parameters()}
            out["t_grads"] = _flat(iknet_to_flax(dict(grads, **{
                k: v for k, v in t_net.state_dict().items() if "running" in k}))["params"])
            out["t_first"] = _flat(iknet_to_flax(t_net.state_dict()))
    j = jax_runs["futures"]["iknet"].result()
    out.update(j=j["metrics"], j_grads=j["grads"], first=(j["first"], out["t_first"]),
               last=(j["last"], _flat(iknet_to_flax(t_net.state_dict()))), net=t_net)
    return out


def test_iknet_step_against_jax(iknet_run):
    r = iknet_run
    keys = ("loss", "l_quat", "l_joints")
    _hold_step(r["t"][0], r["j"][0], keys, 1e-5)
    _hold_grads(r["t_grads"], r["j_grads"])
    _hold_step(r["t"][-1], r["j"][-1], keys, 5e-3)
    for (j_flat, t_flat), steps, within, share, stats in (
            (r["first"], 1, 1e-6, 0.99, dict(mean=(0, 1e-6), var=(1e-5, 1e-6))),
            (r["last"], N_STEPS, 1e-4, 0.95, dict(mean=(0, 3e-3), var=(1e-2, 0)))):
        _hold_params({k: v for k, v in t_flat.items() if k.startswith("params/")},
                     {k: v for k, v in j_flat.items() if k.startswith("params/")}, IK_LR, steps,
                     within, share)
        for k, v in j_flat.items():
            if k.startswith("batch_stats/"):
                rtol, atol = stats[k.rsplit("/", 1)[1]]
                np.testing.assert_allclose(t_flat[k], v, rtol=rtol, atol=atol, err_msg=k)


def test_save_iknet_params_loads_in_jax(iknet_run, tmp_path):
    path = str(tmp_path / "iknet.npz")
    t_fit.save_iknet_params(iknet_run["net"], path)
    loaded = _flat(jax.device_get(j_fit.load_iknet_params(path)))
    want = _flat(iknet_to_flax(iknet_run["net"].state_dict()))
    assert sorted(loaded) == sorted(want) == sorted(iknet_run["last"][0])
    for k, v in want.items():
        assert loaded[k].dtype == v.dtype and np.array_equal(loaded[k], v), k
    back = t_fit.load_iknet_params(path)
    for k, v in iknet_run["net"].state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back[k], v), k


def test_iknet_batchnorm_repair():
    """Evaluation is torch's BatchNorm1d's, bit for bit, on the in-repo
    weights; one train-mode forward updates the running statistics with the
    biased variance (flax's), where nn.BatchNorm1d folds in the unbiased."""
    from torch import nn

    from artiboost_torch.utils.misc import asset_path

    state = t_fit.load_iknet_params(asset_path("assets/iknet_tpu.npz"))
    net, old = TIKNet(), TIKNet()
    old.bn = nn.ModuleList(nn.BatchNorm1d(m.num_features, eps=1e-5, momentum=0.1)
                           for m in old.bn)
    net.load_state_dict(state)
    old.load_state_dict(state)
    x = torch.from_numpy(np.random.RandomState(1).randn(32, 21, 3).astype(np.float32) * 0.3)
    for a, b in zip(net.eval()(x), old.eval()(x)):
        assert torch.equal(a, b)
    bn = net.bn[0]
    h = torch.relu(net.dense[0](x.reshape(32, 63))).detach()
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    bn.train()(h)
    var = h.var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), (0.9 * mean0 + 0.1 * h.mean(0)).numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * var0 + 0.1 * var).numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("script", ["refiner", "iknet"])
def test_scripts_run_on_the_cpu(script, tmp_path):
    out = str(tmp_path / f"{script}.npz")
    if script == "refiner":
        res = train_refiner.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                                  "--obj_points", "64", "--out", out, "--log_freq", "1"])
        assert np.isfinite(res["scrambled_mm"]) and np.isfinite(res["refined_mm"])
        t_ref.build_refiner({"TYPE": "hand_obj", "PRETRAINED": out}, t_mano(), device="cpu")
    else:
        res = train_iknet.main(["--device", "cpu", "--steps", "3", "--out", out,
                                "--log_freq", "1"])
        assert np.isfinite(res["fit_err_mm"])
        TIKNet().load_state_dict(t_fit.load_iknet_params(out))
    assert len(res["losses"]) == 3 and all(np.isfinite(m["loss"]) for m in res["losses"])
