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
from artiboost_torch.utils.registry import LOSS, build_from_cfg


def build_criterion(cfg: Dict) -> Criterion:
    """{"CRITERION": [loss cfgs], "LAMBDAS": [...]} -> Criterion, each loss
    built through the LOSS registry (a TYPE it does not know raises
    ``KeyError``, as JAX's ``criterion.py:68-71``)."""
    return Criterion(cfg["LAMBDAS"], [build_from_cfg(c, LOSS) for c in cfg["CRITERION"]])


__all__ = ["Criterion", "TensorLoss", "build_criterion", "AlignLoss", "ChamferLoss",
           "ManoLoss", "ObjLoss", "HandJointsLoss", "JointsLoss", "HandOrdLoss", "SceneOrdLoss",
           "SymCornerLoss"]
