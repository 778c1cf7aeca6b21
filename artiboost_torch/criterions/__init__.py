"""Losses of the port and the YAML ``CRITERION`` builder."""
from __future__ import annotations

from typing import Dict

from artiboost_torch.criterions.alignloss import AlignLoss
from artiboost_torch.criterions.chamferloss import ChamferLoss
from artiboost_torch.criterions.criterion import Criterion, TensorLoss
from artiboost_torch.criterions.honetloss import ManoLoss, ObjLoss
from artiboost_torch.criterions.jointloss import HandJointsLoss, JointsLoss
from artiboost_torch.criterions.ordinal import HandOrdLoss, SceneOrdLoss
from artiboost_torch.criterions.symcornerloss import SymCornerLoss

LOSSES = {cls.__name__: cls for cls in (JointsLoss, HandJointsLoss, HandOrdLoss, SceneOrdLoss,
                                        ManoLoss, ObjLoss, SymCornerLoss, AlignLoss, ChamferLoss)}


def build_criterion(cfg: Dict) -> Criterion:
    """{"CRITERION": [loss cfgs], "LAMBDAS": [...]} -> Criterion. A loss
    type that is not ported raises with its name."""
    losses = []
    for c in cfg["CRITERION"]:
        c = dict(c)
        kind = c.pop("TYPE")
        if kind not in LOSSES:
            raise NotImplementedError(f"loss {kind!r} is not ported yet (ported: {sorted(LOSSES)})")
        losses.append(LOSSES[kind](**c))
    return Criterion(cfg["LAMBDAS"], losses)


__all__ = ["Criterion", "TensorLoss", "LOSSES", "build_criterion"]
