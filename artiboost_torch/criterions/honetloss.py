"""MANO regularisers and geometry losses, and the object-vertex loss
(counterpart of ``artiboost_tpu/criterions/honetloss.py``; reference
``anakin/criterions/honetloss.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.parallel.mesh import shard_normaliser
from artiboost_torch.utils.batching import key_validity, masked_sample_mean


def _masked_mse_3d(pred: torch.Tensor, targ: torch.Tensor, m: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """MSE over (B, N, 3) with an optional (B,) validity mask: masked
    samples give zero and leave the denominator."""
    return masked_sample_mean(torch.mean((pred - targ) ** 2, dim=(1, 2)), m)


class ManoLoss(TensorLoss):
    def __init__(self, LAMBDA_JOINTS_3D: float = 0.0, LAMBDA_HAND_VERTS_3D: float = 0.0,
                 LAMBDA_SHAPE_REG: float = 0.0, LAMBDA_POSE_REG: float = 0.0, **_):
        super().__init__()
        self.lambda_joints_3d = float(LAMBDA_JOINTS_3D)
        self.lambda_hand_verts_3d = float(LAMBDA_HAND_VERTS_3D)
        self.lambda_shape_reg = float(LAMBDA_SHAPE_REG)
        self.lambda_pose_reg = float(LAMBDA_POSE_REG)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        if self.lambda_shape_reg:
            shape_reg = torch.mean(preds["mano_shape"] ** 2)
            final_loss = final_loss + self.lambda_shape_reg * shape_reg
            losses["mano_shape"] = shape_reg
        if self.lambda_pose_reg:
            pose_reg = torch.mean(preds["mano_pca_pose"][:, 3:] ** 2)
            final_loss = final_loss + self.lambda_pose_reg * pose_reg
            losses["mano_pca_pose"] = pose_reg
        root = targs[Queries.ROOT_JOINT][:, None]
        for lam, name, pred_key, targ_key in (
                (self.lambda_joints_3d, "joints_3d_loss", "joints_3d_abs", Queries.JOINTS_3D),
                (self.lambda_hand_verts_3d, "hand_verts_3d_loss", "hand_verts_3d_abs",
                 Queries.HAND_VERTS_3D)):
            if lam and targ_key in targs:
                loss = _masked_mse_3d(preds[pred_key], targs[targ_key] + root,
                                      key_validity(targs, targ_key, Queries.ROOT_JOINT))
                final_loss = final_loss + lam * loss
                losses[name] = loss
        losses[self.output_key] = final_loss
        return final_loss, losses


class ObjLoss(TensorLoss):
    """MSE of the object's camera-space vertices: the model's
    ``obj_verts_3d_abs`` when it predicts them, else the predicted box pose
    applied to the canonical vertices; masked by PADDING_MASK and by the
    KEY_VALID masks of the keys it reads."""

    def __init__(self, LAMBDA_OBJ_VERTS_3D: float = 0.0, **_):
        super().__init__()
        self.lambda_obj_verts_3d = float(LAMBDA_OBJ_VERTS_3D)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        if self.lambda_obj_verts_3d and Queries.OBJ_VERTS_3D in targs:
            targ = targs[Queries.OBJ_VERTS_3D] + targs[Queries.ROOT_JOINT][:, None]
            if "obj_verts_3d_abs" in preds:
                pred = preds["obj_verts_3d_abs"]
            else:
                pred = (torch.einsum("bij,bnj->bni", preds["box_rot_rotmat"],
                                     targs[Queries.OBJ_VERTS_CAN])
                        + preds["boxroot_3d_abs"].reshape(-1, 1, 3))
            mask = targs.get(Queries.PADDING_MASK)
            m = key_validity(targs, Queries.OBJ_VERTS_3D, Queries.OBJ_VERTS_CAN,
                             Queries.ROOT_JOINT)
            if m is not None:
                mask = m[:, None].expand(pred.shape[:2]) if mask is None else mask * m[:, None]
            if mask is not None:
                diff = ((pred - targ) ** 2) * mask[..., None]
                loss = torch.sum(diff) / (shard_normaliser(torch.sum(mask)) * 3.0 + 1e-8)
            else:
                loss = torch.mean((pred - targ) ** 2)
            final_loss = final_loss + self.lambda_obj_verts_3d * loss
            losses["obj_verts_3d_loss"] = loss
        losses[self.output_key] = final_loss
        return final_loss, losses
