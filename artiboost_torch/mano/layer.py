"""MANO forward kinematics (LBS) on torch tensors (counterpart of
``artiboost_tpu/mano/layer.py``): FK over the kinematic tree one level
at a time (the five finger chains in parallel), batched LBS."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from artiboost_torch.mano.model import JOINT_REORDER, NUM_JOINTS, TIP_VERT_IDS, ManoModel
from artiboost_torch.utils.misc import device_constant
from artiboost_torch.utils.transform import aa_to_rotmat

_LEV1 = [1, 4, 7, 10, 13]
_LEV2 = [2, 5, 8, 11, 14]
_LEV3 = [3, 6, 9, 12, 15]


class ManoOutput(NamedTuple):
    verts: torch.Tensor           # (B, 778, 3)
    joints: torch.Tensor          # (B, 21, 3) conventional order
    transforms_abs: torch.Tensor  # (B, 16, 4, 4) MANO-native order
    full_poses: Optional[torch.Tensor]  # (B, 48); None from mano_forward_rotmat


def _with_zeros_row(rt: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4)."""
    pad = torch.zeros(rt.shape[:-2] + (1, 4), dtype=rt.dtype, device=rt.device)
    pad[..., 0, 3] = 1.0
    return torch.cat([rt, pad], dim=-2)


def _shaped(model: ManoModel, betas: torch.Tensor) -> torch.Tensor:
    return model.v_template[None] + torch.einsum("vds,bs->bvd", model.shapedirs, betas)


def pca_to_axisang(model: ManoModel, pose_coeffs: torch.Tensor, ncomps: int,
                   flat_hand_mean: bool = True) -> torch.Tensor:
    """(B, 3 + ncomps) PCA pose -> (B, 48) full axis-angle pose: the global
    rotation, then the coefficients times the first ``ncomps`` rows of
    ``hands_components``, plus ``hands_mean`` unless ``flat_hand_mean``."""
    hand = pose_coeffs[:, 3:3 + ncomps] @ model.hands_components[:ncomps]
    if not flat_hand_mean:
        hand = hand + model.hands_mean
    return torch.cat([pose_coeffs[:, :3], hand], dim=1)


def mano_forward(model: ManoModel, full_pose: torch.Tensor, betas: torch.Tensor,
                 center_idx: Optional[int] = None) -> ManoOutput:
    """(B, 48) axis-angle pose + (B, 10) shape -> verts, 21 joints, transforms."""
    rots = aa_to_rotmat(full_pose.reshape(full_pose.shape[0], 16, 3))
    return _mano_forward_impl(model, rots, full_pose, betas, center_idx)


def mano_forward_rotmat(model: ManoModel, rots: torch.Tensor, betas: torch.Tensor,
                        center_idx: Optional[int] = None) -> ManoOutput:
    """FK straight from (B, 16, 3, 3) joint rotations, for loops over a 6D
    or rotmat pose: ``rotmat_to_aa``'s backward is singular at angle 0 and
    pi. ``full_poses`` is None: JAX reports the axis-angle pose here, but
    its jit drops that conversion when nothing reads it, and no caller
    does (``utils.transform.rotmat_to_aa`` gives it)."""
    return _mano_forward_impl(model, rots, None, betas, center_idx)


def _mano_forward_impl(model: ManoModel, rots: torch.Tensor, full_pose: Optional[torch.Tensor],
                       betas: torch.Tensor, center_idx: Optional[int]) -> ManoOutput:
    B = rots.shape[0]
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feature = (rots[:, 1:] - eye).reshape(B, 135)

    v_shaped = _shaped(model, betas)
    j_rest = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_feature)

    root_tf = _with_zeros_row(torch.cat([rots[:, 0], j_rest[:, 0, :, None]], dim=-1))

    def ids(values):  # index tensors made on the device once
        return device_constant(tuple(values), rots.device, torch.int64)

    lev = [ids([0] * 5), ids(_LEV1), ids(_LEV2), ids(_LEV3)]

    def level(parent_tf, jids, parent_jids):
        rel_t = j_rest[:, jids] - j_rest[:, parent_jids]
        rel = _with_zeros_row(torch.cat([rots[:, jids], rel_t[..., None]], dim=-1))
        return parent_tf @ rel

    lev1 = level(root_tf[:, None].expand(B, 5, 4, 4), lev[1], lev[0])
    lev2 = level(lev1, lev[2], lev[1])
    lev3 = level(lev2, lev[3], lev[2])

    transforms_abs = torch.zeros((B, NUM_JOINTS, 4, 4), dtype=rots.dtype, device=rots.device)
    transforms_abs[:, 0] = root_tf
    transforms_abs[:, lev[1]] = lev1
    transforms_abs[:, lev[2]] = lev2
    transforms_abs[:, lev[3]] = lev3

    # transforms act about each rest joint: subtract A_j @ [j_rest, 0]
    j_h = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], dim=-1)
    skinning_tf = transforms_abs.clone()
    skinning_tf[..., :4, 3] -= torch.einsum("bjik,bjk->bji", transforms_abs, j_h)

    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    tf_v = torch.einsum("vj,bjik->bvik", model.lbs_weights, skinning_tf)
    verts = torch.einsum("bvik,bvk->bvi", tf_v, v_h)[..., :3]

    joints16 = transforms_abs[:, :, :3, 3]
    tips = verts[:, ids(TIP_VERT_IDS)]
    joints21 = torch.cat([joints16, tips], dim=1)[:, ids(JOINT_REORDER)]
    if center_idx is not None:
        center = joints21[:, center_idx:center_idx + 1]
        verts = verts - center
        joints21 = joints21 - center
    return ManoOutput(verts=verts, joints=joints21, transforms_abs=transforms_abs,
                      full_poses=full_pose)


def rotation_center(model: ManoModel, betas: torch.Tensor) -> torch.Tensor:
    """The shaped root joint the global rotation pivots about (manotorch
    ``get_rotation_center``, reference preprocessor.py:55)."""
    return torch.einsum("v,bvd->bd", model.J_regressor[0], _shaped(model, betas))
