"""HoNet, the Hasson CVPR'20-style hand-object net (counterpart of
``artiboost_tpu/models/honet.py``; reference
``anakin/models/honetMANO.py:20-286``): a ManoBranch hand whose absolute
position comes from a pixel-space scale and translation head lifted to
camera space by the focal length (``recover_3d_proj``), and an object head
of scale, pixel translation and an AXIS-ANGLE rotation (not 6D,
``honet.py:81-88``). With ``MANO_FHB_ADAPTOR`` a frozen ManoAdaptor
regresses the FHB joints from the MANO vertices. As in HOPRegNet only the
backbone takes ``ARCH.DTYPE``."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.mano.model import get_mano_model
from artiboost_torch.models.hpregnet import ManoAdaptor, ManoBranch, TransHead, build_mano_head
from artiboost_torch.models.resnet import build_backbone
from artiboost_torch.utils.registry import MODEL
from artiboost_torch.utils.transform import aa_to_rotmat, batch_persp_proj2d


def recover_3d_proj(objpoints3d: torch.Tensor, camintr: torch.Tensor, est_scale: torch.Tensor,
                    est_trans: torch.Tensor, input_res: Tuple[int, int], off_z: float = 0.4):
    """Lift centred points (B, N, 3) to camera space from the predicted
    pixel-space scale (B, 1) and translation (B, 2); ``input_res`` is
    (width, height). -> (points (B, N, 3), centre (B, 1, 3))
    (reference honetMANO.py:113-139)."""
    focal = camintr[:, 0:1, 0]
    est_z0 = focal * est_scale + off_z
    cam_centers = camintr[:, :2, 2]
    img_centers = torch.tensor(input_res, dtype=objpoints3d.dtype,
                               device=objpoints3d.device) / 2.0
    est_xy0 = (est_trans + img_centers - cam_centers) * est_z0 / focal
    est_c3d = torch.cat([est_xy0, est_z0], dim=-1)[:, None]
    return est_c3d + objpoints3d, est_c3d


class HoNet(nn.Module):
    def __init__(self, backbone: nn.Module, mano_branch: ManoBranch,
                 obj_trans_factor: float = 100.0, obj_scale_factor: float = 0.0001,
                 center_idx: int = 9, adaptor: Optional[ManoAdaptor] = None):
        super().__init__()
        self.backbone, self.mano_branch, self.adaptor = backbone, mano_branch, adaptor
        self.mano_transhead = TransHead(backbone.out_channels, 3)
        self.obj_transhead = TransHead(backbone.out_channels, 6)
        self.obj_trans_factor, self.obj_scale_factor = obj_trans_factor, obj_scale_factor
        self.center_idx = center_idx

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image = inputs[Queries.IMAGE]  # (B, H, W, 3)
        res = (image.shape[2], image.shape[1])  # (width, height)
        feature = self.backbone(image.permute(0, 3, 1, 2).contiguous())["res_layer4_mean"]
        cam_intr = inputs[Queries.CAM_INTR]

        mano = self.mano_branch(feature)
        joints_3d, hand_verts_3d = mano["joints_3d"], mano["hand_verts_3d"]
        if self.adaptor is not None:
            # FHB skeleton (honetMANO.py:144-155): joints regressed from the
            # vertices, both recentred at center_idx
            adapt = self.adaptor(hand_verts_3d)
            center = adapt[:, self.center_idx][:, None]
            joints_3d, hand_verts_3d = adapt - center, hand_verts_3d - center

        scaletrans = self.mano_transhead(feature)
        joints_3d_abs, root_joint = recover_3d_proj(
            joints_3d, cam_intr, scaletrans[:, 0:1] * self.obj_scale_factor,
            scaletrans[:, 1:] * self.obj_trans_factor, res)
        hand_verts_3d_abs = hand_verts_3d + root_joint

        st_obj = self.obj_transhead(feature)
        rotmat = aa_to_rotmat(st_obj[:, 3:6])
        corners = torch.einsum("bij,bnj->bni", rotmat, inputs[Queries.CORNERS_CAN])
        corners_3d_abs, obj_center = recover_3d_proj(
            corners, cam_intr, st_obj[:, 0:1] * self.obj_scale_factor,
            st_obj[:, 1:3] * self.obj_trans_factor, res)

        out = {}
        if Queries.OBJ_VERTS_CAN in inputs:
            # honetMANO.py:200-236: the canonical vertices take the same
            # rotation and recovered centre
            obj_verts_3d_abs = (torch.einsum("bij,bnj->bni", rotmat, inputs[Queries.OBJ_VERTS_CAN])
                                + obj_center)
            out.update({"obj_verts_3d_abs": obj_verts_3d_abs,
                        "obj_verts_3d": obj_verts_3d_abs - root_joint,
                        "obj_verts_2d": batch_persp_proj2d(obj_verts_3d_abs, cam_intr)})
        return {
            **out,
            "joints_3d_abs": joints_3d_abs,
            "joints_3d": joints_3d,
            "hand_verts_3d_abs": hand_verts_3d_abs,
            "hand_verts_3d": hand_verts_3d,
            "joints_2d": batch_persp_proj2d(joints_3d_abs, cam_intr),
            "hand_verts_2d": batch_persp_proj2d(hand_verts_3d_abs, cam_intr),
            "corners_3d_abs": corners_3d_abs,
            "corners_3d": corners_3d_abs - root_joint,  # from the HAND root (honetMANO.py:250)
            "corners_2d": batch_persp_proj2d(corners_3d_abs, cam_intr),
            "box_rot_rotmat": rotmat,
            "boxroot_3d_abs": obj_center,
            "root_joint": root_joint[:, 0],
            "mano_shape": mano["mano_shape"],
            "mano_pca_pose": mano["mano_pca_pose"],
        }


@MODEL.register_module(name="HoNet")
def build_honet(**cfg) -> HoNet:
    """``honet.py:127-154``: the adaptor's pickle is
    ``MANO_FHB_ADAPTOR_DIR/fhb_skel_centeridx{CENTER_IDX}.pkl``."""
    data_preset = cfg.get("DATA_PRESET", {})
    backbone = build_backbone(cfg)
    center_idx = data_preset.get("CENTER_IDX", 9)
    adaptor = None
    if cfg.get("MANO_FHB_ADAPTOR", False):
        load_path = os.path.join(cfg.get("MANO_FHB_ADAPTOR_DIR", "assets/hasson20_assets/mano"),
                                 f"fhb_skel_centeridx{center_idx}.pkl")
        adaptor = ManoAdaptor(get_mano_model(cfg["HEAD"].get("MANO_ASSETS_ROOT"), device="cpu"),
                              load_path=load_path)
    return HoNet(backbone, build_mano_head(cfg, backbone),
                 obj_trans_factor=cfg.get("OBJ_TRANS_FACTOR", 100.0),
                 obj_scale_factor=cfg.get("OBJ_SCALE_FACTOR", 0.0001),
                 center_idx=center_idx, adaptor=adaptor)
