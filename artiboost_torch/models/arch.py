"""Arch: DAG-of-models composer (counterpart of
``artiboost_tpu/models/arch.py``; reference ``anakin/models/arch.py``).
The single root (the model no other consumes) is evaluated bottom-up,
each node's input dict merged with its upstream outputs. Eval-mode
forward only in this slice."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from artiboost_torch.models.hybrid_baseline import build_hybrid_baseline
from artiboost_torch.utils.misc import resolve_dtype

MODELS = {"HybridBaseline": build_hybrid_baseline}


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
    """The YAML ``ARCH`` entry (dict or list of dicts) -> Arch. ``DTYPE``
    is not applied yet: the port computes in float32."""
    if isinstance(arch_cfg, dict):
        arch_cfg = [arch_cfg]
    names = [c["TYPE"] for c in arch_cfg]
    models, previous = [], []
    for c in arch_cfg:
        if c["TYPE"] not in MODELS:
            raise NotImplementedError(f"model {c['TYPE']!r} is not ported yet")
        if resolve_dtype(c.get("DTYPE")) != torch.float32:
            from artiboost_torch.utils.misc import logger

            logger.warning(f"ARCH.DTYPE {c.get('DTYPE')} is not ported yet; computing in float32")
        models.append(MODELS[c["TYPE"]](c, data_preset))
        previous.append(tuple(names.index(p) for p in (c.get("PREVIOUS") or [])))
    return Arch(models, names, previous)
