"""Bidirectional chamfer loss between the object vertices under the
predicted box pose and the ground truth (counterpart of
``artiboost_tpu/criterions/chamferloss.py``; reference
``anakin/criterions/chamferloss.py:12-52``), on ``ops/chamfer.py``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.ops.chamfer import chamfer_distance
from artiboost_torch.utils.batching import key_validity
from artiboost_torch.utils.registry import LOSS


@LOSS.register_module
class ChamferLoss(TensorLoss):
    def __init__(self, LAMBDA_CHAMFER: float = 0.0, **_):
        super().__init__()
        self.lambda_chamfer = float(LAMBDA_CHAMFER)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        if self.lambda_chamfer:
            pred = (torch.einsum("bij,bnj->bni", preds["box_rot_rotmat"],
                                 targs[Queries.OBJ_VERTS_CAN])
                    + preds["boxroot_3d_abs"].reshape(-1, 1, 3))
            targ = targs[Queries.OBJ_VERTS_3D] + targs[Queries.ROOT_JOINT][:, None]
            sample_vis = torch.any(targs[Queries.CORNERS_VIS] > 0, dim=1).float()
            m = key_validity(targs, Queries.OBJ_VERTS_3D, Queries.OBJ_VERTS_CAN,
                             Queries.ROOT_JOINT)
            if m is not None:
                sample_vis = sample_vis * m
            pad = targs.get(Queries.PADDING_MASK)
            dist_xy, dist_yx = chamfer_distance(pred * sample_vis[:, None, None],
                                                targ * sample_vis[:, None, None],
                                                mask_x=pad, mask_y=pad)
            loss = torch.mean(dist_xy) + torch.mean(dist_yx)
            final_loss = final_loss + self.lambda_chamfer * loss
            losses["chamfer_loss"] = loss
        losses[self.output_key] = final_loss
        return final_loss, losses
