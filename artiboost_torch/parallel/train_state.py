"""Optimizer, scheduler and the train / eval steps (counterpart of
``artiboost_tpu/parallel/train_state.py``; reference ``train/train_artiboost.py``
epoch_pass: forward -> criterion -> backward -> clip -> optimizer step, and
``anakin/utils/netutils.py:26,44`` for the factories).

The train step is the torch shape of ``make_mixed_train_step`` (:222-268):
the caller assembles the mixed batch (``utils.batching.union_concat``) and
the step runs forward in train mode (BatchNorm updates its running
averages there), the criterion, backward, optax's global-norm clip and the
optimizer step. The learning rate follows the schedule at the count of
updates made so far, as optax's ``scale_by_schedule`` does."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from artiboost_torch.criterions.criterion import Criterion
from artiboost_torch.utils.misc import resolve_device


def build_scheduler(cfg: Dict, base_lr: float) -> Callable[[int], float]:
    """step (StepLR), cosine (warmup + cosine decay to 0) or linear (warmup
    + linear decay to 0): update count -> learning rate.

    ``step`` counts LR_DECAY_STEP in optimizer updates times
    STEPS_PER_EPOCH, which nothing sets, so it stays 1: the JAX package's
    fault (:27-34; the reference counts epochs), kept for parity."""
    kind = str(cfg.get("SCHEDULER", "step")).lower()
    if kind in ("step", "steplr"):
        period = int(cfg.get("LR_DECAY_STEP", 100)) * int(cfg.get("STEPS_PER_EPOCH", 1))
        gamma = float(cfg.get("LR_DECAY_GAMMA", 1.0))
        return lambda step: base_lr * gamma ** (step // period)
    total = int(cfg.get("TOTAL_STEPS", 10000))
    warm = int(cfg.get("WARMUP_STEPS", 0))
    if kind not in ("cosine", "linear"):
        raise ValueError(f"unknown scheduler {kind}")

    def schedule(step: int) -> float:
        if step < warm:
            return base_lr * step / warm
        t = min(step - warm, total - warm) / max(total - warm, 1)
        if kind == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))
        return base_lr * (1.0 - t)

    return schedule


def _decay_mask(name: str) -> bool:
    """Weight decay everywhere except frozen buffers: ManoAdaptor's
    ``regressor`` (the JAX package's ``_decay_mask``, :48-60)."""
    return "regressor" not in name.split(".")


def build_optimizer(cfg: Dict, named_params: List[Tuple[str, torch.nn.Parameter]]
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """TRAIN cfg -> (optimizer, schedule). adam (optax.adam, eps 1e-8), adam
    with WEIGHT_DECAY (optax.adamw under ``_decay_mask``), sgd with
    MOMENTUM. The rate is set per update from the schedule."""
    base_lr = float(cfg.get("LR", 1e-4))
    sched = build_scheduler(cfg, base_lr)
    name = str(cfg.get("OPTIMIZER", "adam")).lower()
    wd = float(cfg.get("WEIGHT_DECAY", 0.0))
    params = [p for _, p in named_params]
    if name == "adam" and wd:
        groups = [{"params": [p for n, p in named_params if _decay_mask(n)], "weight_decay": wd},
                  {"params": [p for n, p in named_params if not _decay_mask(n)],
                   "weight_decay": 0.0}]
        opt = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=float(cfg.get("MOMENTUM", 0.9)))
    else:
        raise ValueError(f"unknown optimizer {name}")
    return opt, sched


@torch.no_grad()
def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: when the global norm g of the gradients
    exceeds max_norm, each gradient becomes (grad / g) * max_norm. Returns g."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    scale_down = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(scale_down, g / norm * max_norm, g))
    return norm


class TrainStep:
    """step(batch, loss_draws) -> (preds, losses), both detached.
    ``forward_backward`` and ``update`` are its two halves: after the first,
    each parameter's ``.grad`` holds the raw gradient. The model is moved to
    ``device`` (None means CUDA, which raises without a card)."""

    def __init__(self, model: torch.nn.Module, criterion: Criterion, train_cfg: Dict,
                 device=None):
        self.model, self.criterion = model.to(resolve_device(device)), criterion
        self.named_params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self.named_params]
        self.optimizer, self.schedule = build_optimizer(train_cfg, self.named_params)
        self.grad_clip = float(train_cfg.get("GRAD_CLIP", 0.0))
        self.step = 0

    def forward_backward(self, batch: Dict, loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        preds = self.model(batch)
        total, losses = self.criterion.compute_losses(preds, batch, loss_draws)
        total.backward()
        return ({k: v.detach() for k, v in preds.items()},
                {k: v.detach() for k, v in losses.items()})

    def update(self):
        if self.grad_clip:
            clip_by_global_norm(self.params, self.grad_clip)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def __call__(self, batch: Dict, loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
        out = self.forward_backward(batch, loss_draws)
        self.update()
        return out


@torch.no_grad()
def eval_step(model: torch.nn.Module, criterion: Criterion, batch: Dict,
              loss_draws: List[Dict]) -> Tuple[Dict, Dict]:
    """Forward with the running statistics, and the criterion's losses
    (``make_eval_step``, :282-293)."""
    model.eval()
    preds = model(batch)
    _, losses = criterion.compute_losses(preds, batch, loss_draws)
    return preds, losses
