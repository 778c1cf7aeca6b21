"""Six full train steps of the Clas, Reg and HoNet models on both packages
(forward, backward, global-norm clip, Adam; float32, 64 x 64, batches of
4) from one flax initialisation over the same six batches and ordinal
draws, so the two runs differ in no input; torch at one thread. Held, at
3x the figures measured here (TRACK): the largest relative departure of a
step's final_loss from JAX's, and after the last step the largest
distance of a parameter tensor from JAX's over the distance it moved."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from artiboost_torch.criterions import build_criterion as t_crit
from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.parallel.train_state import TrainStep
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import FROM_FLAX
from artiboost_tpu.criterions import build_criterion as j_crit
from artiboost_tpu.models import build_arch as j_build_arch
from artiboost_tpu.parallel.train_state import build_optimizer
from tests.test_torch_models_reg import HONET, REG, S, _train_batch
from tests.test_torch_train import jax_loss_draws, to_torch_draws

CLAS = "config/synthetic_smoke.yaml"
STEPS = 6
# config: (bound on a step's final_loss, on the parameters' distance from
# JAX's over their movement), each 3x the figure measured here
TRACK = {CLAS: (8.5e-3, 0.38), REG: (4.7e-4, 0.034), HONET: (1.2e-3, 0.043)}


@pytest.mark.parametrize("path", list(TRACK))
def test_train_steps_track_jax(path):
    """Measured (loss, parameters): Clas (config/synthetic_smoke.yaml)
    2.81e-3, 0.124; Reg 1.56e-4, 0.0113; HoNet 3.98e-4, 0.0142. After the
    first step a tensor is within a few 1e-4 of its movement (the
    gradients' float32 noise, tests/test_torch_models_reg.py
    ``test_train_step_gradients``); each step then grows that 2-3x. With no
    input difference the Reg and HoNet updates part from JAX's no faster
    than the Clas model's, whose gate holds them over 16 steps
    (tests/test_torch_gate.py)."""
    cfg = load_config(path)
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[S, S])
    rng = np.random.RandomState(8)
    batches = [_train_batch(rng) for _ in range(STEPS)]
    jarch, jcrit = j_build_arch(cfg["ARCH"], preset), j_crit(cfg)
    variables = jax.jit(lambda k, b: jarch.init(k, b, train=True))(
        jax.random.PRNGKey(9), {k: jnp.asarray(v) for k, v in batches[0].items()})
    params, stats = variables["params"], variables["batch_stats"]
    tx, _ = build_optimizer(cfg["TRAIN"])
    opt_state = tx.init(params)
    convert = FROM_FLAX[cfg["ARCH"]["TYPE"]]

    def flat(params, stats):
        """The flax state in the port's names and layouts."""
        m0 = lambda tree: jax.tree_util.tree_map(np.asarray, tree["model_list_0"])  # noqa: E731
        return convert({"params": m0(params), "batch_stats": m0(stats)})

    tarch = t_build_arch(cfg["ARCH"], preset)
    model = tarch.model_list[0]
    model.load_state_dict(flat(params, stats))
    step = TrainStep(tarch, t_crit(cfg), cfg["TRAIN"], device="cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}

    @jax.jit
    def jax_step(params, stats, opt_state, batch, key):
        def loss_fn(p):
            preds, new = jarch.apply({"params": p, "batch_stats": stats}, batch, train=True,
                                     mutable=["batch_stats"])
            final, losses = jcrit.compute_losses(preds, batch, key)
            return final, (losses, new["batch_stats"])

        (_, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, losses

    loss_dev = 0.0  # at one thread (conftest.py): the reductions' order, whatever the machine
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        params, stats, opt_state, jl = jax_step(
            params, stats, opt_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        _, tl = step({k: torch.from_numpy(v) for k, v in batch.items()},
                     to_torch_draws(jax_loss_draws(jax, key, jcrit)))
        loss_dev = max(loss_dev, abs(float(tl["final_loss"]) / float(jl["final_loss"]) - 1))
    want = flat(params, stats)
    param_dev = max(float((p.detach() - torch.from_numpy(np.asarray(want[n]))).norm()
                          / (torch.from_numpy(np.asarray(want[n])) - start[n]).norm())
                    for n, p in model.named_parameters() if p.requires_grad)
    print(f"{path}: final_loss {loss_dev:.3e}, parameters {param_dev:.3e}")
    bound_loss, bound_param = TRACK[path]
    assert loss_dev <= bound_loss and param_dev <= bound_param, (loss_dev, param_dev)

