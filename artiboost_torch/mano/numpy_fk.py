"""Host-side numpy rotation helpers that the real-data pipeline uses
(copies of ``aa_to_rotmat_np``, ``rotmat_to_aa_np`` and
``mirror_mano_pose`` from ``artiboost_tpu/mano/numpy_fk.py``, which the
port keeps its own copy of)."""
from __future__ import annotations

import numpy as np


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
