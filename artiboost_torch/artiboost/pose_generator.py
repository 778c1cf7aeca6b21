"""Pose generator: sampled (obj, view, grasp) triplets -> camera-space
hand/object poses (counterpart of ``artiboost_tpu/artiboost/pose_generator.py``;
reference ``anakin/artiboost/preprocessor.py``): MANO FK of the grasp,
rotation into the sampled view with the rotation-center-compensated
translation (:55-60), the camera offset, scrambling and refinement."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from artiboost_torch.artiboost.grasp_library import GraspLibrary
from artiboost_torch.artiboost.object_library import ObjectLibrary
from artiboost_torch.artiboost.view_engine import (
    ViewEngineConfig,
    sample_view,
    sample_view_draws,
)
from artiboost_torch.mano.layer import mano_forward, rotation_center
from artiboost_torch.mano.model import ManoModel
from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.transform import aa_to_rotmat, rotmat_to_aa, rt_to_transf


class GeneratedPoses(NamedTuple):
    """Compact pose cache."""

    obj_id: torch.Tensor      # (N,) int64
    persp_id: torch.Tensor    # (N,)
    grasp_id: torch.Tensor    # (N,)
    obj_pose: torch.Tensor    # (N, 4, 4) camera-space object pose
    hand_pose: torch.Tensor   # (N, 48) refined pose (before the roll)
    hand_shape: torch.Tensor  # (N, 10)
    hand_tsl: torch.Tensor    # (N, 3)
    cam_offset: torch.Tensor  # (N, 3)
    cam_free: torch.Tensor    # (N, 3, 3) in-plane roll to re-apply


def cat_poses(pieces, n: int) -> GeneratedPoses:
    """Concatenate pose-cache chunks and trim to n entries."""
    return GeneratedPoses(*(torch.cat(xs, dim=0)[:n] for xs in zip(*pieces)))


def decode_final_hand(mano_model: ManoModel, gen: GeneratedPoses, idx: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Final hand verts/joints for a slice of the cache: cam_offset, then
    cam_free (reference preprocessor.py:83-88)."""
    out = mano_forward(mano_model, gen.hand_pose[idx], gen.hand_shape[idx])
    tsl, off = gen.hand_tsl[idx][:, None], gen.cam_offset[idx][:, None]
    rotf = gen.cam_free[idx]
    verts = torch.einsum("bij,bnj->bni", rotf, out.verts + tsl + off)
    joints = torch.einsum("bij,bnj->bni", rotf, out.joints + tsl + off)
    return {"hand_verts": verts, "joints": joints}


def rotate_hand_global(mano_model: ManoModel, rot: torch.Tensor, hand_pose: torch.Tensor,
                       hand_shape: torch.Tensor, hand_tsl: torch.Tensor):
    """Re-express a MANO pose under a global rotation about the origin:
    FK(pose', shape) + tsl' == rot @ (FK(pose, shape) + tsl). Returns
    (pose', tsl')."""
    root_rot = aa_to_rotmat(hand_pose[:, :3])
    glob = rotmat_to_aa(rot @ root_rot)
    new_pose = torch.cat([glob, hand_pose[:, 3:]], dim=1)
    center = rotation_center(mano_model, hand_shape)
    offset_0 = center - torch.einsum("bij,bj->bi", root_rot, center)
    offset_1 = center - torch.einsum("bij,bj->bi", aa_to_rotmat(new_pose[:, :3]), center)
    new_tsl = torch.einsum("bij,bj->bi", rot, offset_0 + hand_tsl) - offset_1
    return new_pose, new_tsl


class PoseGenerator:
    """generate(oid, vid, gid, draws) -> GeneratedPoses, with
    ``draws(generator, B)`` the random half (view jitter + scrambler)."""

    def __init__(self, mano_model: ManoModel, obj_lib: ObjectLibrary,
                 grasp_lib: GraspLibrary, view_cfg: ViewEngineConfig,
                 scrambler, refiner: Callable):
        self.mano_model = mano_model
        self.obj_lib = obj_lib
        self.grasp_lib = grasp_lib
        self.view_cfg = view_cfg
        self.scrambler = scrambler
        self.refiner = refiner

    def draws(self, generator: torch.Generator, B: int, device=None) -> Dict:
        device = resolve_device(device)
        return {"view": sample_view_draws(generator, B, self.view_cfg, device),
                "scram": self.scrambler.draws(generator, B, device)}

    def __call__(self, oid: torch.Tensor, vid: torch.Tensor, gid: torch.Tensor,
                 draws: Dict) -> GeneratedPoses:
        B = oid.shape[0]
        hand_pose, hand_shape, hand_tsl = self.grasp_lib.gather(oid, gid)
        joints = mano_forward(self.mano_model, hand_pose, hand_shape).joints + hand_tsl[:, None]

        persp, cam_free, z_offset = sample_view(self.view_cfg, vid, draws["view"])
        persp_inv = persp.transpose(1, 2)
        op_offset = torch.einsum("bij,bj->bi", persp_inv, joints[:, 9]) / 2.0
        cam_offset = z_offset - op_offset
        obj_pose = rt_to_transf(persp_inv, cam_offset)
        zeros = torch.zeros((B, 3), dtype=obj_pose.dtype, device=obj_pose.device)
        obj_pose = rt_to_transf(cam_free, zeros) @ obj_pose

        new_pose, new_tsl = rotate_hand_global(self.mano_model, persp_inv, hand_pose,
                                               hand_shape, hand_tsl)
        new_out = mano_forward(self.mano_model, new_pose, hand_shape)
        scram = self.scrambler({
            "hand_pose": new_pose, "hand_tsl": new_tsl,
            "joints": new_out.joints + new_tsl[:, None],
            "hand_verts": new_out.verts + new_tsl[:, None],
            "hand_transf": new_out.transforms_abs,
        }, draws["scram"])

        overts_rot = torch.einsum("bij,bnj->bni", persp_inv, self.obj_lib.verts[oid])
        refined = self.refiner(
            {"hand_pose": scram["hand_pose"], "hand_tsl": scram["hand_tsl"],
             "hand_shape": hand_shape},
            overts_rot, self.obj_lib.vert_valid[oid])
        return GeneratedPoses(
            obj_id=oid, persp_id=vid, grasp_id=gid, obj_pose=obj_pose,
            hand_pose=refined["hand_pose"], hand_shape=hand_shape,
            hand_tsl=refined["hand_tsl"], cam_offset=cam_offset, cam_free=cam_free)
