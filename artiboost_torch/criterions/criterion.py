"""Weighted-sum loss aggregator (counterpart of
``artiboost_tpu/criterions/criterion.py``; reference
``anakin/criterions/criterion.py``).

A loss is a callable ``loss(preds, targs, draws) -> (scalar, dict)``. Its
random half is split out: ``loss.draws(generator, device)`` makes the
dict of draws one call consumes (empty for a deterministic loss), and
``Criterion.draws`` makes one such dict per loss, where the JAX package
splits one PRNG key per loss (:55-58)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from artiboost_torch.utils.misc import resolve_device


def camel_to_snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and not name[i - 1].isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class TensorLoss:
    """Base: the output_key naming convention and no draws."""

    def __init__(self):
        self.output_key = f"{camel_to_snake(type(self).__name__)}_output"

    def draws(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        return {}

    def __call__(self, preds: Dict, targs: Dict, draws: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError


class Criterion:
    """sum_i LAMBDAS[i] * loss_i; ``compute_losses`` returns the total and
    every loss's named terms plus ``final_loss``."""

    def __init__(self, lambdas: Sequence[float], loss_list: List[TensorLoss]):
        self.loss_list = loss_list
        self.loss_lambdas = {type(loss).__name__: float(lam)
                             for loss, lam in zip(loss_list, lambdas)}

    def draws(self, generator: torch.Generator, device=None) -> List[Dict[str, torch.Tensor]]:
        device = resolve_device(device)
        return [loss.draws(generator, device) for loss in self.loss_list]

    def compute_losses(self, preds: Dict, targs: Dict, draws: List[Dict]
                       ) -> Tuple[torch.Tensor, Dict]:
        total = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        all_losses: Dict[str, torch.Tensor] = {}
        for loss, d in zip(self.loss_list, draws):
            final_loss, losses = loss(preds, targs, d)
            total = total + self.loss_lambdas[type(loss).__name__] * final_loss
            all_losses.update(losses)
        all_losses["final_loss"] = total
        return total, all_losses
