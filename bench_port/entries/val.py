"""The val entry: the window's unit is a val sweep as ``train.run`` orders
it (``loader.prepare_val()``, the sweep's poses drawn without replacement;
``train.val_epoch``; then the mining step, which the harness runs). Set-up
warms up with the first ``warmup_batches`` batches of a sweep.

Its traffic file holds ``entry``, ``recipe`` (dotted keys of the recipe set
for the cell) and ``warmup_batches``. The check: sampled batches of the
window's last sweep through the reference's forward, and the EPE (and,
with the AR metric, MSSD) map entries of their triplets."""
from __future__ import annotations

from typing import Dict

TRAFFIC = {"entry", "recipe", "warmup_batches"}
SWEEP_RANGE = "artiboost/prepare_val"
RATE = "val_img_s"


def build_loader(env):
    from artiboost_torch import train as T
    from artiboost_torch.artiboost.loader import ArtiBoostLoader

    r = env.recipe
    return ArtiBoostLoader(None, cfg=T.slice_config(r), batch_size=env.bs,
                           n_epochs=int(r["TRAIN"]["EPOCH"]), seed=env.seed, device=env.dev)


def n_batches(env) -> int:
    return -(-int(env.recipe["MANAGER"]["VAL_LEN"]) // env.bs)


def setup(env):
    from artiboost_torch import train as T

    env.restore.append(env.cap.val_hook(T))
    n_warm = int(env.traffic.get("warmup_batches", 2))
    env.cap.arm(n_warm)
    env.loader.prepare_val()
    gv = env.loader.generated_val
    env.loader.generated_val = type(gv)(*(x[:n_warm * env.bs] for x in gv))
    T.val_epoch(env.loader, env.arch, env.criterion, env.evaluator, env.timer, epoch=0)
    env.loader.step_eval(0, env.evaluator)
    env.loader.generated_val = gv


def arm(env):
    n = n_batches(env)
    env.cap.arm(n, val_want=env.rng.choice(n, min(int(env.check["val_batches"]), n),
                                           replace=False).tolist())


def sweep(env):
    env.loader.prepare_val()
    return env.loader.generated_val


def unit(env, k: int) -> Dict:
    from artiboost_torch import train as T

    out = T.val_epoch(env.loader, env.arch, env.criterion, env.evaluator, env.timer, epoch=k)
    return {"steps": out["batches"], "images": out["images"], "final_loss": []}


def gather(env, mesh):
    pass


def check(env, variant: str, checks, ref_model) -> Dict[str, float]:
    env.checked_batches = env.cap.val
    return checks.val_gaps(ref_model, env.recipe, env.w0, env.cap.val, env.cap.snap,
                           env.cfg.get("models_info"), variant)
