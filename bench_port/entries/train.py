"""The train entry: the window's unit is an epoch as ``train.run`` orders it
(``loader.prepare()``, the epoch's pose sweep; ``train.train_epoch``; then
the mining step, which the harness runs), on the synthetic data alone: the
loader gets no real dataset.

Its traffic file holds ``entry`` and ``recipe`` (dotted keys of the recipe
set for the cell) and nothing else. The check: the set-up's first steps,
held against the reference's from the seeded weights, and the first steps
of the window's last epoch, held against the reference's from the state
the program's parameters, running statistics and Adam moments were in
when that epoch began; each on the same batches and loss draws."""
from __future__ import annotations

from typing import Dict

import torch

TRAFFIC = {"entry", "recipe"}
SWEEP_RANGE = "artiboost/prepare"
RATE = "train_img_s"


def build_loader(env):
    from artiboost_torch import train as T
    from artiboost_torch.artiboost.loader import ArtiBoostLoader

    r = env.recipe
    return ArtiBoostLoader(None, cfg=T.slice_config(r), batch_size=env.bs,
                           n_epochs=int(r["TRAIN"]["EPOCH"]), seed=env.seed, device=env.dev)


def steps_per_unit(env) -> int:
    return max(int(env.recipe["MANAGER"]["CONFIG_LEN_TRAIN"]) // env.bs, 1)


def plant(env, fault):
    """The faults of a train step: its state returned unchanged; the loss
    taken over the first half of each batch."""
    step = env.step
    if fault == "unchanged_state":
        step.update = lambda: setattr(step, "step", step.step + 1)
    if fault == "half_batch":
        crit = step.criterion
        orig = crit.compute_losses

        def half(preds, batch, draws):
            B = batch["image"].shape[0]

            def cut(d):
                return {k: v[:B // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == B else v
                        for k, v in d.items()}
            return orig(cut(preds), cut(batch), draws)
        crit.compute_losses = half
        env.restore.append(lambda: delattr(crit, "compute_losses"))


def setup(env):
    """The train step, then the set-up's short epoch of ``check.steps``
    steps through ``train_epoch``'s own call, kept for the check."""
    from artiboost_torch import train as T
    from artiboost_torch.parallel.train_state import TrainStep

    env.step = TrainStep(env.arch, env.criterion, env.recipe["TRAIN"], device=env.dev)
    plant(env, env.fault)
    env.restore.append(env.cap.step_hooks(env.step))
    n = env.n_check
    env.cap.arm(n, n_steps=n, step=env.step)
    # the first steps start from the seeded weights, not from what the program loaded
    start = env.cap.steps["start"]
    start["w"] = {k: env.w0[k] for k in start["w"]}
    env.loader.prepare()
    full = env.loader.config_len_train
    env.loader.config_len_train = n * env.bs
    T.train_epoch(env.loader, env.step, env.evaluator, env.timer, env.summarizer,
                  pipeline=env.pipeline, epoch=0)
    env.loader.step_eval(0, env.evaluator)
    env.loader.config_len_train = full
    env.first = env.cap.steps


def arm(env):
    env.cap.arm(steps_per_unit(env), n_steps=env.n_check, step=env.step)


def sweep(env):
    env.loader.prepare()
    return env.loader.generated


def unit(env, k: int) -> Dict:
    from artiboost_torch import train as T

    return T.train_epoch(env.loader, env.step, env.evaluator, env.timer, env.summarizer,
                         pipeline=env.pipeline, epoch=k)


def gather(env, mesh):
    """Under a process group: every rank's rows of the checked batches on
    rank 0, the losses as the global batch's, and how far the ranks'
    parameters after the window's steps lie apart (0 for a sound global
    step)."""
    for s in (env.first, env.cap.steps):
        s["batches"] = [{k: mesh.all_gather_rows(v) for k, v in b.items()} for b in s["batches"]]
        s["losses"] = list(mesh.all_reduce_mean(torch.stack(s["losses"])))
        s["preds1"] = {k: mesh.all_gather_rows(v) for k, v in s["preds1"].items()}
    w = env.cap.steps["w_after"]
    mine = torch.cat([w[k].reshape(-1).float() for k in sorted(w)])
    ref0 = mesh.broadcast_(mine.clone())
    env.rank_spread = float(mesh.all_reduce_sum_((mine - ref0).abs().max().reshape(1))[0])


def check(env, variant: str, checks, ref_model) -> Dict[str, float]:
    """The numbers of the set-up's steps and (``win_``) of the window's."""
    nums, detail = {}, {}
    for prefix, s in (("", env.first), ("win_", env.cap.steps)):
        start = s["start"]
        ref = env.ref_cache.get(prefix)
        if ref is None:
            ref = env.ref_cache[prefix] = ref_model.train_steps(env.recipe, start, s["batches"],
                                                                s["draws"])
        if variant == "program":
            m0 = start["m"]
            got = {"loss": [float(x) for x in s["losses"]], "w": s["w_after"],
                   "preds1": s["preds1"],
                   "grad1": {k: (s["m1"][k].double() - 0.9 * m0[k].double()) / 0.1 for k in m0}}
        else:
            got = ref_model.train_steps(
                env.recipe, start, s["batches"], s["draws"],
                precision={"control": "fp8", "bf16": "bf16"}.get(variant, "fp32"),
                rows=slice(0, env.bs // 2) if variant == "half" else None)
        n = checks.train_gaps(ref, got["loss"], got["grad1"], got["w"], start["w"], got["preds1"],
                              prefix)
        detail[prefix or "first"] = n.pop("detail")
        nums.update(n)
    env.details[variant] = detail
    env.checked_batches = env.first["batches"] + env.cap.steps["batches"]
    return nums
