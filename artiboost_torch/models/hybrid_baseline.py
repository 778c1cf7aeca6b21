"""HybridBaseline, the released "Clas" ArtiBoost model (counterpart of
``artiboost_tpu/models/hybrid_baseline.py``; reference
``anakin/models/hybridbaseline.py:18-103``): ResNet backbone,
IntegralDeconvHead over 22 classes (21 joints + box root), and an MLP
predicting the object's 6D rotation; corners are R @ corners_can +
boxroot and reprojected for the 2D output. Inputs are NHWC images,
converted to NCHW inside. ``ARCH.DTYPE`` sets the compute dtype of the
three sub-networks (a sub-network's own DTYPE overrides it, as in
``hybrid_baseline.py:82-87``); their outputs and the geometry are
float32."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.models.integral_head import IntegralDeconvHead
from artiboost_torch.models.mlp import MLP
from artiboost_torch.models.resnet import build_backbone
from artiboost_torch.utils.misc import CONST, device_constant
from artiboost_torch.utils.registry import MODEL, build_head, build_model
from artiboost_torch.utils.transform import batch_uvd2xyz, rot6d_to_rotmat


class HybridBaseline(nn.Module):
    def __init__(self, backbone: nn.Module, hybrid_head: IntegralDeconvHead, box_head: MLP,
                 inp_res: Tuple[int, int] = (224, 224), center_idx: int = 9):
        super().__init__()
        self.backbone, self.hybrid_head, self.box_head = backbone, hybrid_head, box_head
        self.inp_res = tuple(inp_res)
        self.center_idx = center_idx

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image = inputs[Queries.IMAGE]  # (B, H, W, 3)
        height, width = image.shape[1], image.shape[2]
        feats = self.backbone(image.permute(0, 3, 1, 2).contiguous())
        pose = self.hybrid_head(feats["res_layer4"])
        box_rot_6d = self.box_head(feats["res_layer4_mean"])

        intr = inputs[Queries.CAM_INTR]
        pose_3d_abs = batch_uvd2xyz(pose["kp3d"], inputs[Queries.ROOT_JOINT], intr,
                                    inp_res=self.inp_res)
        joints_3d_abs = pose_3d_abs[:, 0:CONST.NUM_JOINTS]
        boxroot_3d_abs = pose_3d_abs[:, CONST.NUM_JOINTS:CONST.NUM_JOINTS + 1]
        box_rot_rotmat = rot6d_to_rotmat(box_rot_6d)
        corners_3d_abs = (torch.einsum("bij,bnj->bni", box_rot_rotmat,
                                       inputs[Queries.CORNERS_CAN]) + boxroot_3d_abs)
        root_joint = joints_3d_abs[:, self.center_idx]
        hom = torch.einsum("bij,bnj->bni", intr, corners_3d_abs)
        corners_2d = hom[..., :2] / torch.clamp_min(hom[..., 2:], 1e-8)
        corners_2d = corners_2d / device_constant((width, height), corners_2d.device,
                                                  corners_2d.dtype)
        corners_2d_uvd = torch.cat([corners_2d, torch.zeros_like(corners_2d[..., :1])], -1)
        final_2d_uvd = torch.cat([pose["kp3d"][:, 0:21], corners_2d_uvd,
                                  pose["kp3d"][:, 21:22]], dim=1)
        return {
            "joints_3d_abs": joints_3d_abs,
            "corners_3d_abs": corners_3d_abs,
            "joints_3d": joints_3d_abs - root_joint[:, None],
            "corners_3d": corners_3d_abs - root_joint[:, None],
            "2d_uvd": final_2d_uvd,
            "boxroot_3d_abs": boxroot_3d_abs,
            "box_rot_rotmat": box_rot_rotmat,
            "joints_confd": pose["kp3d_confd"][:, :21],
        }


@MODEL.register_module(name="HybridBaseline")
def build_hybrid_baseline(**cfg) -> HybridBaseline:
    """``hybrid_baseline.py:77-94``: the backbone, the HYBRID_HEAD and the
    BOX_HEAD through their registries, in the arch's DTYPE unless their
    own says otherwise."""
    data_preset = cfg.get("DATA_PRESET", {})
    sub = {"DTYPE": cfg["DTYPE"]} if cfg.get("DTYPE") else {}
    backbone = build_backbone(cfg)
    head = build_head({**sub, **cfg["HYBRID_HEAD"]},
                      {**data_preset, "INPUT_CHANNEL": backbone.out_channels})
    box = build_model({**sub, **cfg["BOX_HEAD"]}, data_preset)
    return HybridBaseline(backbone, head, box,
                          inp_res=tuple(data_preset.get("IMAGE_SIZE", (224, 224))),
                          center_idx=data_preset.get("CENTER_IDX", 9))
