"""Arch: DAG-of-models composer (counterpart of
``artiboost_tpu/models/arch.py``; reference ``anakin/models/arch.py``).
The single root (the model no other consumes) is evaluated bottom-up,
each node's input dict merged with its upstream outputs. ``train()`` /
``eval()`` switch the BatchNorms between batch and running statistics,
as flax's ``train`` flag does."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

# the models register themselves under the JAX package's names
from artiboost_torch.models import honet, hpregnet, hybrid_baseline, simple_baseline  # noqa: F401
from artiboost_torch.utils.registry import build_model


class Arch(nn.Module):
    def __init__(self, models: List[nn.Module], names: List[str],
                 previous: List[Tuple[int, ...]]):
        super().__init__()
        self.model_list = nn.ModuleList(models)
        self.names, self.previous = list(names), list(previous)
        consumed = {i for prevs in previous for i in prevs}
        roots = [i for i in range(len(models)) if i not in consumed]
        if len(roots) != 1:
            raise ValueError(f"Arch DAG must have exactly one root, got {roots}")
        self.root = roots[0]

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cache: Dict[int, Dict[str, torch.Tensor]] = {}

        def run(idx: int):
            if idx not in cache:
                feed = dict(inputs)
                for up in self.previous[idx]:
                    feed.update(run(up))
                cache[idx] = self.model_list[idx](feed)
            return cache[idx]

        return run(self.root)


def build_arch(arch_cfg, data_preset: Dict[str, Any]) -> Arch:
    """The YAML ``ARCH`` entry (dict or list of dicts) -> Arch, each model
    built through the MODEL registry with ``DATA_PRESET`` (``arch.py:55-66``;
    an unknown TYPE raises ``KeyError``). Each model applies its own
    ``DTYPE`` (float32 when absent)."""
    if isinstance(arch_cfg, dict):
        arch_cfg = [arch_cfg]
    names = [c["TYPE"] for c in arch_cfg]
    models, previous = [], []
    for c in arch_cfg:
        models.append(build_model(c, {"DATA_PRESET": data_preset}))
        previous.append(tuple(names.index(p) for p in (c.get("PREVIOUS") or [])))
    return Arch(models, names, previous)
