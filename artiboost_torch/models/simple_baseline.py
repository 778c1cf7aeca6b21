"""SimpleBaseline, a heatmap model over 29 keypoints, 21 joints and 8
corners (counterpart of ``artiboost_tpu/models/simple_baseline.py``;
reference ``anakin/models/simplebaseline.py:194-241``): ResNet features ->
IntegralDeconvHead -> uvd -> camera space from the root joint."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.models.integral_head import IntegralDeconvHead
from artiboost_torch.models.resnet import build_backbone
from artiboost_torch.utils.misc import CONST
from artiboost_torch.utils.registry import MODEL, build_head
from artiboost_torch.utils.transform import batch_uvd2xyz


class SimpleBaseline(nn.Module):
    def __init__(self, backbone: nn.Module, pose_head: IntegralDeconvHead,
                 inp_res: Tuple[int, int] = (224, 224), center_idx: int = 9):
        super().__init__()
        self.backbone, self.pose_head = backbone, pose_head
        self.inp_res, self.center_idx = tuple(inp_res), center_idx

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = self.backbone(inputs[Queries.IMAGE].permute(0, 3, 1, 2).contiguous())
        pose = self.pose_head(feats["res_layer4"])
        kp3d_abs = batch_uvd2xyz(pose["kp3d"], inputs[Queries.ROOT_JOINT],
                                 inputs[Queries.CAM_INTR], inp_res=self.inp_res)
        joints_3d_abs = kp3d_abs[:, :CONST.NUM_JOINTS]
        corners_3d_abs = kp3d_abs[:, CONST.NUM_JOINTS:]
        root_joint = joints_3d_abs[:, self.center_idx]
        return {
            "joints_3d_abs": joints_3d_abs,
            "corners_3d_abs": corners_3d_abs,
            "joints_3d": joints_3d_abs - root_joint[:, None],
            "corners_3d": corners_3d_abs - root_joint[:, None],
            "2d_uvd": pose["kp3d"],
            "joints_confd": pose["kp3d_confd"][:, :CONST.NUM_JOINTS],
            "corners_confd": pose["kp3d_confd"][:, CONST.NUM_JOINTS:],
        }


@MODEL.register_module(name="SimpleBaseline")
def build_simple_baseline(**cfg) -> SimpleBaseline:
    data_preset = cfg.get("DATA_PRESET", {})
    sub = {"DTYPE": cfg["DTYPE"]} if cfg.get("DTYPE") else {}
    backbone = build_backbone(cfg)
    head = build_head({**sub, **cfg["HEAD"]},
                      {**data_preset, "INPUT_CHANNEL": backbone.out_channels})
    return SimpleBaseline(backbone, head,
                          inp_res=tuple(data_preset.get("IMAGE_SIZE", (224, 224))),
                          center_idx=data_preset.get("CENTER_IDX", 9))
