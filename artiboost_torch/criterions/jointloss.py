"""Visibility-masked MSE on joints and corners (counterpart of
``artiboost_tpu/criterions/jointloss.py``; reference
``anakin/criterions/jointloss.py:14-67``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.utils.batching import key_validity
from artiboost_torch.utils.registry import LOSS


def _masked_mse(pred: torch.Tensor, targ: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """MSE over all elements after zeroing invisible keypoints (the mean
    over B * N * 3, not over the visible count, as the reference does)."""
    return torch.mean((pred * vis[..., None] - targ * vis[..., None]) ** 2)


def _fold_valid(vis: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    """AND a (B,) union-batch validity mask into a (B, N) vis map. Callers
    fold ROOT_JOINT's validity in too: abs targets are targ + root."""
    return vis if m is None else vis * m[:, None]


def _abs_loss(preds: Dict, targs: Dict, pred_key: str, targ_key: str, vis_key: str):
    root = targs[Queries.ROOT_JOINT][:, None]
    vis = _fold_valid(targs[vis_key], key_validity(targs, targ_key, Queries.ROOT_JOINT))
    return _masked_mse(preds[pred_key], targs[targ_key] + root, vis)


@LOSS.register_module
class JointsLoss(TensorLoss):
    def __init__(self, LAMBDA_JOINTS_3D: float = 0.0, LAMBDA_CORNERS_3D: float = 0.0, **_):
        super().__init__()
        self.lambda_joints_3d = float(LAMBDA_JOINTS_3D)
        self.lambda_corners_3d = float(LAMBDA_CORNERS_3D)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        if self.lambda_joints_3d:
            j = _abs_loss(preds, targs, "joints_3d_abs", Queries.JOINTS_3D, Queries.JOINTS_VIS)
            final_loss = final_loss + self.lambda_joints_3d * j
            losses["joints_3d_loss"] = j
        if self.lambda_corners_3d:
            c = _abs_loss(preds, targs, "corners_3d_abs", Queries.CORNERS_3D,
                          Queries.CORNERS_VIS)
            final_loss = final_loss + self.lambda_corners_3d * c
            losses["corners_3d_loss"] = c
        losses[self.output_key] = final_loss
        return final_loss, losses


@LOSS.register_module
class HandJointsLoss(TensorLoss):
    def __init__(self, LAMBDA_JOINTS_3D: float = 1.0, **_):
        super().__init__()
        self.lambda_joints_3d = float(LAMBDA_JOINTS_3D)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        j = _abs_loss(preds, targs, "joints_3d_abs", Queries.JOINTS_3D, Queries.JOINTS_VIS)
        final_loss = self.lambda_joints_3d * j
        return final_loss, {"joints_3d_loss": j, self.output_key: final_loss}
