"""Host-side numpy MANO helpers that the real-data pipeline uses: the
rotation helpers ``aa_to_rotmat_np``, ``rotmat_to_aa_np`` and
``mirror_mano_pose``, and ``NumpyMano``, single-sample forward kinematics
for the dataset loaders' hand annotations and contact filters (the port's
own copies of ``artiboost_tpu/mano/numpy_fk.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from artiboost_torch.mano.model import (
    JOINT_REORDER,
    KINTREE_PARENTS,
    NUM_JOINTS,
    TIP_VERT_IDS,
    ManoModel,
)


def aa_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices (Rodrigues)."""
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(theta, 1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([
        np.stack([zero, -z, y], -1),
        np.stack([z, zero, -x], -1),
        np.stack([-y, x, zero], -1),
    ], -2)
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return (eye + s * K + (1.0 - c) * (K @ K)).astype(np.float32)


def rotmat_to_aa_np(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> (3,) axis-angle."""
    R = np.asarray(R, np.float64)
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3, np.float32)
    if np.pi - theta < 1e-6:  # near pi: the axis from R + I
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # signs from the off-diagonals
        if axis[0] > 1e-6:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 1e-6:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        return (axis * theta).astype(np.float32)
    vec = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (vec / (2.0 * np.sin(theta)) * theta).astype(np.float32)


def mirror_mano_pose(pose48: np.ndarray) -> np.ndarray:
    """Mirror an axis-angle MANO pose across the x = 0 plane (left <->
    right hand): each axis-angle's y and z components negate."""
    out = np.asarray(pose48, np.float32).reshape(16, 3).copy()
    out[:, 1] *= -1
    out[:, 2] *= -1
    return out.reshape(-1)


class NumpyMano:
    """Single-sample MANO FK on the host, with the reference layer's
    ``use_pca`` / ``ncomps`` / ``flat_hand_mean`` knobs."""

    def __init__(self, model: ManoModel, use_pca: bool = False, ncomps: int = 45,
                 flat_hand_mean: bool = True):
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        self.v_template = host(model.v_template)
        self.shapedirs = host(model.shapedirs)
        self.posedirs = host(model.posedirs)
        self.J_regressor = host(model.J_regressor)
        self.lbs_weights = host(model.lbs_weights)
        self.hands_components = host(model.hands_components)
        self.hands_mean = host(model.hands_mean)
        self.use_pca, self.ncomps, self.flat_hand_mean = use_pca, ncomps, flat_hand_mean

    def full_pose(self, pose: np.ndarray) -> np.ndarray:
        """(3 + ncomps,) PCA or (48,) axis-angle -> (48,) full axis-angle."""
        pose = np.asarray(pose, np.float32).reshape(-1)
        if self.use_pca:
            hand = pose[3:3 + self.ncomps] @ self.hands_components[:self.ncomps]
            if not self.flat_hand_mean:
                hand = hand + self.hands_mean
            return np.concatenate([pose[:3], hand]).astype(np.float32)
        full = pose.astype(np.float32).copy()
        if not self.flat_hand_mean:
            full[3:] = full[3:] + self.hands_mean
        return full

    def __call__(self, pose: np.ndarray, betas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (verts (778, 3), joints (21, 3) in the conventional order)."""
        full = self.full_pose(pose)
        betas = np.asarray(betas, np.float32).reshape(-1)
        rots = aa_to_rotmat_np(full.reshape(16, 3))
        pose_feature = (rots[1:] - np.eye(3, dtype=np.float32)).reshape(135)
        v_shaped = self.v_template + self.shapedirs @ betas
        j_rest = self.J_regressor @ v_shaped
        v_posed = v_shaped + self.posedirs @ pose_feature
        transforms = np.zeros((NUM_JOINTS, 4, 4), np.float32)
        for j in range(NUM_JOINTS):
            p = KINTREE_PARENTS[j]
            local = np.eye(4, dtype=np.float32)
            local[:3, :3] = rots[j]
            local[:3, 3] = j_rest[j] - (j_rest[p] if p >= 0 else 0.0)
            transforms[j] = local if p < 0 else transforms[p] @ local
        skinning = transforms.copy()
        skinning[:, :3, 3] -= np.einsum("jik,jk->ji", transforms[:, :3, :3], j_rest)
        T = np.einsum("vj,jik->vik", self.lbs_weights, skinning)
        verts = np.einsum("vik,vk->vi", T[:, :3, :3], v_posed) + T[:, :3, 3]
        joints21 = np.concatenate([transforms[:, :3, 3], verts[list(TIP_VERT_IDS)]])
        return verts.astype(np.float32), joints21[list(JOINT_REORDER)].astype(np.float32)
