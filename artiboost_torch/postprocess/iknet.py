"""IKNet: an MLP from 21 normalised joints to the 16 MANO joint rotations
(counterpart of ``artiboost_tpu/postprocess/iknet.py``; reference
``anakin/postprocess/iknet/model.py``). It gives the fitting unit its
warm start. Weights: ``utils/convert.py`` ``iknet_from_flax`` of the flax
variables in ``assets/iknet_tpu.npz``."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from artiboost_torch.models.layers import BatchNorm1d
from artiboost_torch.utils.transform import quat_to_aa


class IKNet(nn.Module):
    """Six Dense + BatchNorm + ReLU blocks, then a 64-wide quaternion head,
    each quaternion normalised (eps 1e-8). BatchNorm as flax's: eps 1e-5,
    running statistics with momentum 0.9 and, in training, the biased batch
    variance (``models/layers.py`` ``BatchNorm1d``)."""

    def __init__(self, njoints: int = 21,
                 hidden_size_pose: Sequence[int] = (256, 512, 1024, 1024, 512, 256)):
        super().__init__()
        self.njoints = njoints
        widths = [njoints * 3, *hidden_size_pose]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.bn = nn.ModuleList(BatchNorm1d(w) for w in hidden_size_pose)
        self.head = nn.Linear(widths[-1], 16 * 4)

    def forward(self, joints: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """joints (B, 21, 3) -> (so3 (B, 48), quats (B, 16, 4) wxyz)."""
        x = joints.reshape(joints.shape[0], self.njoints * 3)
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        quat = self.head(x).reshape(-1, 16, 4)
        quat = quat / torch.clamp_min(torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
        return quat_to_aa(quat).reshape(-1, 48), quat
