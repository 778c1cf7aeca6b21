"""HOPRegNet, the MANO-parameter regression model ("Reg"; counterpart of
``artiboost_tpu/models/hpregnet.py``; reference
``anakin/models/hpregnet.py:19-183``): ResNet features -> ManoBranch (PCA
or rotmat pose + shape -> MANO FK) for the hand, and a 9-dim TransHead
(translation from the hand root 3 + rot6d 6) for the object.

The JAX package's build functions hand ``ARCH.DTYPE`` to the backbone
alone: ManoBranch and TransHead keep flax's default float32
(``hpregnet.py:165-191``), so their Linear layers take the backbone's bf16
features up to float32 and FK runs in float32. The MANO tensors ride as
non-persistent buffers: they move with the module and stay out of the
state dict, as they stay out of the flax variables."""
from __future__ import annotations

import os
import pickle
from typing import Dict

import torch
from torch import nn

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.mano.layer import mano_forward, mano_forward_rotmat, pca_to_axisang
from artiboost_torch.mano.model import JOINT_REORDER, TIP_VERT_IDS, ManoModel, get_mano_model
from artiboost_torch.models.layers import Linear
from artiboost_torch.models.resnet import build_backbone
from artiboost_torch.utils.registry import HEAD, MODEL, build_head
from artiboost_torch.utils.transform import (batch_persp_proj2d, rot6d_to_rotmat, rotmat_proj,
                                             rotmat_to_aa)


class TransHead(nn.Module):
    """in -> in/2 -> out MLP (reference hpregnet.py:53), float32 whatever
    the features' dtype."""

    def __init__(self, inp_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = Linear(inp_dim, inp_dim // 2)
        self.fc2 = Linear(inp_dim // 2, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class ManoBranch(nn.Module):
    """MLP -> MANO pose + shape -> FK (reference mano.py:45-133). PCA mode:
    3 + ncomps coefficients through ``pca_to_axisang``; rotmat mode: 16 x 9
    raw outputs projected onto SO(3) (``rotmat_proj``) and FK from the
    rotations, the axis-angle pose reported detached."""

    def __init__(self, mano_model: ManoModel, inp_dim: int = 512, ncomps: int = 15,
                 use_pca: bool = True, use_shape: bool = True, center_idx: int = 9):
        super().__init__()
        for name, t in zip(ManoModel._fields, mano_model):
            self.register_buffer(f"mano_{name}", t.detach().cpu(), persistent=False)
        self.ncomps, self.use_pca, self.use_shape = ncomps, use_pca, use_shape
        self.center_idx = center_idx
        self.fc1 = Linear(inp_dim, 512)
        self.fc2 = Linear(512, 512)
        self.pose = Linear(512, ncomps + 3 if use_pca else 16 * 9)
        self.shape = Linear(512, 10) if use_shape else None

    @property
    def mano(self) -> ManoModel:
        """The MANO tensors on the module's device."""
        return ManoModel(*(getattr(self, f"mano_{n}") for n in ManoModel._fields))

    def forward(self, feature: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.fc2(torch.relu(self.fc1(feature))))
        pose = self.pose(x)
        shape = (self.shape(x) if self.use_shape else
                 torch.zeros((feature.shape[0], 10), dtype=torch.float32, device=feature.device))
        mano = self.mano
        if self.use_pca:
            full_pose = pca_to_axisang(mano, pose, self.ncomps, flat_hand_mean=False)
            out = mano_forward(mano, full_pose, shape, center_idx=self.center_idx)
        else:
            rots = rotmat_proj(pose.reshape(-1, 16, 3, 3))
            out = mano_forward_rotmat(mano, rots, shape, center_idx=self.center_idx)
            full_pose = rotmat_to_aa(rots.detach()).reshape(-1, 48)
        return {"hand_verts_3d": out.verts, "joints_3d": out.joints, "mano_shape": shape,
                "mano_pca_pose": pose, "mano_full_pose": full_pose}


class ManoAdaptor(nn.Module):
    """Frozen linear 778-vertex -> 21-joint regressor (reference
    ``anakin/models/mano.py:13-41``): from the FHB adaptor pickle's
    ``adaptor`` when ``load_path`` exists, else MANO's J_regressor with the
    fingertip vertices appended, in the 21-joint order. A parameter with
    ``requires_grad=False``, as in the reference, so no optimizer moves it;
    ``parallel.train_state._decay_mask`` keeps weight decay off it too."""

    def __init__(self, mano_model: ManoModel, load_path: str = ""):
        super().__init__()
        if load_path and os.path.isfile(load_path):
            with open(load_path, "rb") as f:
                reg = torch.as_tensor(pickle.load(f)["adaptor"], dtype=torch.float32)
        else:
            reg16 = mano_model.J_regressor.detach().float().cpu()
            tips = torch.zeros((5, reg16.shape[1]), dtype=reg16.dtype)
            for row, vid in enumerate(TIP_VERT_IDS):
                tips[row, vid] = 1.0
            reg = torch.cat([reg16, tips], dim=0)[list(JOINT_REORDER)]
        self.regressor = nn.Parameter(reg.contiguous(), requires_grad=False)

    def forward(self, verts: torch.Tensor) -> torch.Tensor:
        return torch.einsum("jv,bvc->bjc", self.regressor, verts)


class HOPRegNet(nn.Module):
    def __init__(self, backbone: nn.Module, mano_branch: ManoBranch):
        super().__init__()
        self.backbone, self.mano_branch = backbone, mano_branch
        self.obj_transfhead = TransHead(backbone.out_channels, 9)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feature = self.backbone(inputs[Queries.IMAGE].permute(0, 3, 1, 2).contiguous()
                                )["res_layer4_mean"]
        cam_intr, root_joint = inputs[Queries.CAM_INTR], inputs[Queries.ROOT_JOINT]
        mano = self.mano_branch(feature)
        joints_3d_abs = mano["joints_3d"] + root_joint[:, None]
        hand_verts_3d_abs = mano["hand_verts_3d"] + root_joint[:, None]

        transf = self.obj_transfhead(feature)
        tsl_wrt_hand = transf[:, :3]
        rotmat = rot6d_to_rotmat(transf[:, 3:])
        obj_center = root_joint + tsl_wrt_hand
        corners_3d_abs = (torch.einsum("bij,bnj->bni", rotmat, inputs[Queries.CORNERS_CAN])
                          + obj_center[:, None])
        return {
            "joints_3d_abs": joints_3d_abs,
            "joints_3d": mano["joints_3d"],
            "hand_verts_3d_abs": hand_verts_3d_abs,
            "hand_verts_3d": mano["hand_verts_3d"],
            "joints_2d": batch_persp_proj2d(joints_3d_abs, cam_intr),
            "corners_3d_abs": corners_3d_abs,
            "corners_3d": corners_3d_abs - root_joint[:, None],
            "corners_2d": batch_persp_proj2d(corners_3d_abs, cam_intr),
            "obj_center": obj_center,
            "obj_pred_tsl": tsl_wrt_hand,
            "obj_pred_rot": rotmat,
            "box_rot_rotmat": rotmat,
            "boxroot_3d_abs": obj_center[:, None],
            "mano_shape": mano["mano_shape"],
            "mano_pca_pose": mano["mano_pca_pose"],
            "mano_full_pose": mano["mano_full_pose"],
        }


@HEAD.register_module(name="ManoAdaptor")
def build_mano_adaptor(**cfg) -> ManoAdaptor:
    """The HEAD registry's ``ManoAdaptor`` (``hpregnet.py:161-166``)."""
    return ManoAdaptor(get_mano_model(cfg.get("MANO_ASSETS_ROOT"), device="cpu"),
                       load_path=cfg.get("LOAD_PATH", ""))


@HEAD.register_module(name="ManoBranch")
def build_mano_branch(**head) -> ManoBranch:
    """The HEAD registry's ``ManoBranch`` (``hpregnet.py:169-179``): float32,
    ``flat_hand_mean`` False, CENTER_IDX from the head or (as a default)
    DATA_PRESET; ``INPUT_DIM`` is the backbone's width (a default the
    models' builders give; flax infers it)."""
    return ManoBranch(get_mano_model(head.get("MANO_ASSETS_ROOT"), device="cpu"),
                      inp_dim=head.get("INPUT_DIM", 512), ncomps=head.get("NCOMPS", 15),
                      use_pca=head.get("USE_PCA", True), use_shape=head.get("USE_SHAPE", True),
                      center_idx=head.get("CENTER_IDX", 9))


def build_mano_head(cfg: Dict, backbone: nn.Module) -> nn.Module:
    """An ARCH entry's HEAD through the HEAD registry, with DATA_PRESET and
    the backbone's width as defaults."""
    return build_head(cfg["HEAD"], {**cfg.get("DATA_PRESET", {}),
                                    "INPUT_DIM": backbone.out_channels})


@MODEL.register_module(name="HOPRegNet")
def build_hopregnet(**cfg) -> HOPRegNet:
    backbone = build_backbone(cfg)
    return HOPRegNet(backbone, build_mano_head(cfg, backbone))
