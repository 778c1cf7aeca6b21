"""Where the Reg family's drift from JAX comes from (ROADMAP C.3). The
file holds no test; from the repository root run

    python -m tests.test_torch_reg_drift_witness [STEPS] [exact]

(default 10 steps of config/synthetic_smoke_reg.yaml; about a minute on the
CPU; ``exact`` gives the JAX model's BatchNorms ``use_fast_variance=False``
for this run, by a stand-in for the ``nn`` namespace of
``artiboost_tpu/models/resnet.py``). It takes
``tests/test_torch_train_steps.py``'s train steps (float32, 64 x 64, batches
of 4, the same batches and ordinal draws on both sides, so the two runs
differ in no input) and prints, step by step:

- free: the port's own run against JAX's, the step's ``final_loss`` apart
  (relative) and the parameters' largest distance from JAX's over their
  movement, as that test measures them after its last step;
- reset: JAX's state before the step copied into a second port model, then
  one forward and backward on the step's batch: the loss apart, the
  prediction that parts most (relative to its norm), the gradient tensor
  that parts most and the gradients' median gap, the criterion's gradients
  with respect to the predictions (both sides from JAX's predictions), and
  both packages' float32 gradients against the port's in float64.

That is the noise a step adds when both sides start from one state: a gap
that stands out at one key, beyond float32's, marks an op that computes
something else; flat reset gaps under a growing free gap mark float noise
growing through the steps."""
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from artiboost_torch.criterions import build_criterion as t_crit
from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.parallel.train_state import TrainStep
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.convert import FROM_FLAX
from artiboost_tpu.criterions import build_criterion as j_crit
from artiboost_tpu.models import build_arch as j_build_arch
from artiboost_tpu.parallel.train_state import build_optimizer
from tests.test_torch_models_reg import REG, S, _train_batch
from tests.test_torch_train import jax_loss_draws, to_torch_draws


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _exact_variance_batchnorm():
    """The JAX ResNet's BatchNorms with ``use_fast_variance=False``, for
    this process (the package's file is untouched)."""
    from flax import linen

    import artiboost_tpu.models.resnet as jres

    nn = types.SimpleNamespace(**{k: getattr(linen, k) for k in dir(linen)
                                  if not k.startswith("__")})
    nn.BatchNorm = functools.partial(linen.BatchNorm, use_fast_variance=False)
    jres.nn = nn


def _float64(arch):
    """``arch`` computing in float64 (parameters, buffers, every layer's
    compute dtype)."""
    arch.double()
    for m in arch.modules():
        for attr in ("compute_dtype", "dtype"):
            if getattr(m, attr, None) is torch.float32:
                setattr(m, attr, torch.float64)
    return arch


def main(steps: int = 10, exact: bool = False, path: str = REG):
    jax.config.update("jax_platforms", "cpu")
    if exact:
        _exact_variance_batchnorm()
    torch.set_num_threads(1)
    cfg = load_config(path)
    preset = dict(cfg["DATA_PRESET"], IMAGE_SIZE=[S, S])
    rng = np.random.RandomState(8)
    batches = [_train_batch(rng) for _ in range(steps)]
    jarch, jcrit = j_build_arch(cfg["ARCH"], preset), j_crit(cfg)
    variables = jax.jit(lambda k, b: jarch.init(k, b, train=True))(
        jax.random.PRNGKey(9), {k: jnp.asarray(v) for k, v in batches[0].items()})
    params, stats = variables["params"], variables["batch_stats"]
    tx, _ = build_optimizer(cfg["TRAIN"])
    opt_state = tx.init(params)
    convert = FROM_FLAX[cfg["ARCH"]["TYPE"]]

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree["model_list_0"])

    def build():
        arch = t_build_arch(cfg["ARCH"], preset)
        arch.model_list[0].load_state_dict(convert({"params": host(params),
                                                    "batch_stats": host(stats)}))
        return arch, TrainStep(arch, t_crit(cfg), cfg["TRAIN"], device="cpu")

    (free_arch, free), (reset_arch, reset), (arch64, _) = build(), build(), build()
    _float64(arch64)
    start = {n: p.detach().clone() for n, p in free_arch.model_list[0].named_parameters()}

    @jax.jit
    def jax_step(params, stats, opt_state, batch, key):
        def loss_fn(p):
            preds, new = jarch.apply({"params": p, "batch_stats": stats}, batch, train=True,
                                     mutable=["batch_stats"])
            final, losses = jcrit.compute_losses(preds, batch, key)
            return final, (losses, new["batch_stats"], preds)

        (_, (losses, new_stats, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, losses, preds, grads

    print(f"{path}, {steps} steps{', JAX BatchNorm exact variance' if exact else ''}", flush=True)
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        draws = to_torch_draws(jax_loss_draws(jax, key, jcrit))
        before = convert({"params": host(params), "batch_stats": host(stats)})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        reset_arch.model_list[0].load_state_dict(before)
        tpreds, tlosses = reset.forward_backward(tb, draws)
        arch64.model_list[0].load_state_dict(before)
        arch64.zero_grad(set_to_none=True)
        arch64.train()
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in tb.items()}
        d64 = [{k: v.double() if v.is_floating_point() else v for k, v in d.items()}
               for d in draws]
        reset.criterion.compute_losses(arch64(b64), b64, d64)[0].backward()
        params, stats, opt_state, jl, jpreds, jgrads = jax_step(params, stats, opt_state, jb, key)
        _, fl = free(tb, draws)

        jgrad = convert({"params": host(jgrads), "batch_stats": host(stats)})
        g64 = {n: p.grad.numpy() for n, p in arch64.model_list[0].named_parameters()
               if p.grad is not None}
        grads = dict(reset_arch.model_list[0].named_parameters())
        names = [n for n, p in grads.items()
                 if p.grad is not None and np.linalg.norm(jgrad[n]) > 0]
        gap = {n: _rel(grads[n].grad.numpy(), jgrad[n]) for n in names}
        t64 = {n: _rel(grads[n].grad.numpy(), g64[n]) for n in names}
        j64 = {n: _rel(jgrad[n], g64[n]) for n in names}
        pred_gap = {k: _rel(tpreds[k].detach().float().numpy(), np.asarray(jpreds[k]))
                    for k in tpreds if k in jpreds and np.asarray(jpreds[k]).size}
        dj = jax.grad(lambda pr: jcrit.compute_losses(pr, jb, key)[0])(jpreds)
        tp = {k: torch.from_numpy(np.array(v)).requires_grad_(v.dtype == jnp.float32)
              for k, v in jpreds.items()}
        reset.criterion.compute_losses(tp, tb, draws)[0].backward()
        dpred = max(_rel(t.grad.numpy(), np.asarray(dj[k])) for k, t in tp.items()
                    if t.grad is not None and np.linalg.norm(np.asarray(dj[k])) > 0)

        want = convert({"params": host(params), "batch_stats": host(stats)})
        param_gap = max(float((p.detach() - torch.from_numpy(np.asarray(want[n]))).norm()
                              / max(float((torch.from_numpy(np.asarray(want[n])) - start[n])
                                          .norm()), 1e-30))
                        for n, p in free_arch.model_list[0].named_parameters()
                        if p.requires_grad)
        jf = float(jl["final_loss"])
        worst_pred, worst_grad = max(pred_gap, key=pred_gap.get), max(gap, key=gap.get)
        print(f"step {i}: free {abs(float(fl['final_loss']) / jf - 1):.3e}, {param_gap:.3e} | "
              f"reset {abs(float(tlosses['final_loss']) / jf - 1):.3e}; {worst_pred} "
              f"{pred_gap[worst_pred]:.3e}; {worst_grad} {gap[worst_grad]:.3e}; median "
              f"{np.median(list(gap.values())):.3e}; dL/dpred {dpred:.2e}; against float64: "
              f"port {np.median(list(t64.values())):.2e} (worst {max(t64.values()):.2e}), "
              f"JAX {np.median(list(j64.values())):.2e} (worst {max(j64.values()):.2e} at "
              f"{max(j64, key=j64.get)})", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10, "exact" in sys.argv[2:])
