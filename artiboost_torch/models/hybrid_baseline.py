"""HybridBaseline, the released "Clas" ArtiBoost model (counterpart of
``artiboost_tpu/models/hybrid_baseline.py``; reference
``anakin/models/hybridbaseline.py:18-103``): ResNet backbone,
IntegralDeconvHead over 22 classes (21 joints + box root), and an MLP
predicting the object's 6D rotation; corners are R @ corners_can +
boxroot and reprojected for the 2D output. Inputs are NHWC images,
converted to NCHW inside."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.models.integral_head import IntegralDeconvHead
from artiboost_torch.models.mlp import MLP
from artiboost_torch.models.resnet import build_resnet
from artiboost_torch.utils.misc import CONST
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
        dtype = next(self.parameters()).dtype
        feats = self.backbone(image.permute(0, 3, 1, 2).to(dtype).contiguous())
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
        corners_2d = corners_2d / torch.tensor([width, height], dtype=corners_2d.dtype,
                                               device=corners_2d.device)
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


def build_hybrid_baseline(cfg: Dict, data_preset: Dict) -> HybridBaseline:
    backbone = build_resnet(cfg["BACKBONE"])
    h = cfg["HYBRID_HEAD"]
    head = IntegralDeconvHead(
        in_channels=h.get("INPUT_CHANNEL", backbone.out_channels),
        nclasses=h.get("NCLASSES", 22), depth_res=h.get("DEPTH_RESOLUTION", 28),
        norm_type=h.get("NORM_TYPE", "softmax"),
        deconv_filters=tuple(h.get("NUM_DECONV_FILTERS", (256, 256))),
        deconv_kernels=tuple(h.get("NUM_DECONV_KERNELS", (4, 4))),
        deconv_with_bias=h.get("DECONV_WITH_BIAS", False),
        final_conv_kernel=h.get("FINAL_CONV_KERNEL", 1))
    b = cfg["BOX_HEAD"]
    box = MLP(layers_n=tuple(b.get("LAYERS_N", (512, 256, 128))),
              out_channel=b.get("OUT_CHANNEL", 6))
    return HybridBaseline(backbone, head, box,
                          inp_res=tuple(data_preset.get("IMAGE_SIZE", (224, 224))),
                          center_idx=data_preset.get("CENTER_IDX", 9))
