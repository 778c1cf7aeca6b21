"""Procrustes-aligned joint MSE (counterpart of
``artiboost_tpu/criterions/alignloss.py``; reference
``anakin/criterions/alignloss.py:13-80``) by batched SVD."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.utils.batching import key_validity, masked_sample_mean
from artiboost_torch.utils.registry import LOSS


def orthogonal_procrustes(A: torch.Tensor, B: torch.Tensor):
    """Batched R, s minimising ||B @ R^T * s - A|| (scipy's convention, as
    the reference uses it: the SVD of A^T B)."""
    u, w, vt = torch.linalg.svd(torch.einsum("bni,bnj->bij", A, B))
    return u @ vt, torch.sum(w, dim=1)[:, None, None]


def procrustes_align(xyz: torch.Tensor, pred_xyz: torch.Tensor) -> torch.Tensor:
    """Align ``pred_xyz`` to ``xyz`` by a similarity (s R, t); reference :62-80."""
    tsl = xyz.mean(dim=1, keepdim=True)
    pred_tsl = pred_xyz.mean(dim=1, keepdim=True)
    xyz_c, pred_c = xyz - tsl, pred_xyz - pred_tsl
    n = xyz.shape[0]
    scale = torch.linalg.norm(xyz_c.reshape(n, -1), dim=1)[:, None, None] + 1e-8
    pred_scale = torch.linalg.norm(pred_c.reshape(n, -1), dim=1)[:, None, None] + 1e-8
    xyz_n, pred_n = xyz_c / scale, pred_c / pred_scale
    R, s = orthogonal_procrustes(xyz_n, pred_n)
    return torch.einsum("bni,bji->bnj", pred_n, R) * s * scale + tsl


@LOSS.register_module
class AlignLoss(TensorLoss):
    def __init__(self, LAMBDA_PROCRUSTES_ALIGN: float = 1.0, **_):
        super().__init__()
        self.lambda_procrustes_align = float(LAMBDA_PROCRUSTES_ALIGN)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        targ = targs[Queries.JOINTS_3D] + targs[Queries.ROOT_JOINT][:, None]
        if self.lambda_procrustes_align:
            m = key_validity(targs, Queries.JOINTS_3D, Queries.ROOT_JOINT)
            if m is not None:
                # samples without joint annotations would feed the SVD an
                # all-zero target (NaN gradients): align to the detached
                # prediction instead, so their residual is zero
                targ = torch.where(m[:, None, None] > 0, targ, preds["joints_3d_abs"].detach())
            aligned = procrustes_align(targ, preds["joints_3d_abs"])
            loss = masked_sample_mean(torch.mean((aligned - targ) ** 2, dim=(1, 2)), m)
            final_loss = final_loss + self.lambda_procrustes_align * loss
            losses["procrustes_aligned_loss"] = loss
        losses[self.output_key] = final_loss
        return final_loss, losses
