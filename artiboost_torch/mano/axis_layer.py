"""Per-joint anatomical axes of the hand (counterpart of
``artiboost_tpu/mano/axis_layer.py``; manotorch's AxisLayer, read by the
anatomically-aware scramblers ``random_2`` and ``random_3``).

For each of the 15 articulated finger joints, in world space: ``b_axis``
the bone (twist) direction leaving the joint, ``l_axis`` the bend axis,
orthogonal to the bone and the palm's up direction, and ``u_axis`` the
splay axis completing the frame."""
from __future__ import annotations

from typing import Tuple

import torch

# For each articulated joint 1..15 (MANO-native order: index, middle,
# pinky, ring, thumb x 3 levels), the 21-keypoint index of the joint and
# of the next joint along the finger (the tip for a distal joint).
_JOINT_KP = (5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3)
_CHILD_KP = (6, 7, 8, 10, 11, 12, 18, 19, 20, 14, 15, 16, 2, 3, 4)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-8)


def hand_axes(joints21: torch.Tensor, transforms_abs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """joints21 (B, 21, 3), transforms_abs (B, 16, 4, 4) -> (b_axis,
    u_axis, l_axis), each (B, 15, 3), unit, world space."""
    b = _unit(joints21[:, list(_CHILD_KP)] - joints21[:, list(_JOINT_KP)])
    # palm-up reference: each joint frame's +z column in world space (the
    # MANO rest pose has the back of the hand facing +z)
    up_ref = transforms_abs[:, 1:, :3, 2]
    l = _unit(torch.linalg.cross(up_ref, b))
    u = _unit(torch.linalg.cross(b, l))
    return b, u, l
