"""Symmetry-aware corner loss (counterpart of
``artiboost_tpu/criterions/symcornerloss.py``; reference
``anakin/criterions/symcornerloss.py:18-103``): the MSE between the
predicted corners and the ground-truth corners under each of the object's
symmetries, the least of them per sample. Computed in float32 whatever
``ARCH.DTYPE`` is; invalid (padding) symmetries take float32's max, so
they never win the min."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.utils.batching import key_validity, masked_sample_mean
from artiboost_torch.utils.bop_sym import SymTable, sym_canonical
from artiboost_torch.utils.registry import LOSS


@LOSS.register_module
class SymCornerLoss(TensorLoss):
    def __init__(self, LAMBDA_SYM_CORNERS_3D: float = 0.0, USE_HO3D_YCB: bool = False,
                 MODEL_INFO_PATH=None, MAX_SYM_DISC_STEP: float = 0.01, **_):
        super().__init__()
        self.lambda_sym_corners_3d = float(LAMBDA_SYM_CORNERS_3D)
        self.use_ho3d_ycb = bool(USE_HO3D_YCB)
        self.syms = SymTable(MODEL_INFO_PATH or None, MAX_SYM_DISC_STEP)

    def __call__(self, preds: Dict, targs: Dict, draws=None) -> Tuple[torch.Tensor, Dict]:
        final_loss = torch.zeros((), dtype=torch.float32, device=preds["joints_3d_abs"].device)
        losses = {}
        if self.lambda_sym_corners_3d:
            sym_R, sym_t, sym_valid = self.syms.gather(targs[Queries.OBJ_IDX].long() - 1)
            obj_transf = targs[Queries.OBJ_TRANSF].float()
            sym_can = sym_canonical(sym_R, sym_t, targs[Queries.CORNERS_CAN].float(),
                                    self.use_ho3d_ycb)
            sym_abs = (torch.einsum("bij,bscj->bsci", obj_transf[:, :3, :3], sym_can)
                       + obj_transf[:, None, None, :3, 3])
            vis = targs[Queries.CORNERS_VIS].float()
            m = key_validity(targs, Queries.OBJ_TRANSF, Queries.CORNERS_CAN, Queries.OBJ_IDX)
            if m is not None:
                vis = vis * m[:, None]
            pred = preds["corners_3d_abs"].float() * vis[..., None]
            sym_abs = sym_abs * vis[:, None, :, None]
            per_sym = torch.mean((sym_abs - pred[:, None]) ** 2, dim=(2, 3))
            per_sym = torch.where(sym_valid > 0, per_sym, torch.finfo(torch.float32).max)
            loss = masked_sample_mean(per_sym.min(dim=1).values, m)
            final_loss = final_loss + self.lambda_sym_corners_3d * loss
            losses["sym_corners_3d_loss"] = loss
        losses[self.output_key] = final_loss
        return final_loss, losses
