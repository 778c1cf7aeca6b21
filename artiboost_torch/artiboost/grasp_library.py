"""Grasp library as dense (n_obj, n_grasp, ...) tensors (counterpart of
``artiboost_tpu/artiboost/grasp_library.py``; reference
``anakin/artiboost/grasp_engine.py``). Only the deterministic synthetic
library exists until the grasp assets are in the repository."""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from artiboost_torch.utils.misc import logger, resolve_device


class GraspLibrary(NamedTuple):
    hand_pose: torch.Tensor   # (n_obj, n_grasp, 48) axis-angle
    hand_shape: torch.Tensor  # (n_obj, n_grasp, 10)
    hand_tsl: torch.Tensor    # (n_obj, n_grasp, 3)

    def gather(self, obj_id: torch.Tensor, grasp_id: torch.Tensor):
        """(B,) ids -> (pose (B, 48), shape (B, 10), tsl (B, 3))."""
        return (self.hand_pose[obj_id, grasp_id], self.hand_shape[obj_id, grasp_id],
                self.hand_tsl[obj_id, grasp_id])


def synthetic_grasp_library(n_obj: int, n_grasp: int, seed: int = 0,
                            device=None) -> GraspLibrary:
    """Random global orientation, fingers curled by a random amount, the
    hand a palm-width from the (bbox-centered) object."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    poses = np.zeros((n_obj, n_grasp, 48), np.float32)
    shapes = (rng.randn(n_obj, n_grasp, 10) * 0.3).astype(np.float32)
    tsls = np.zeros((n_obj, n_grasp, 3), np.float32)
    for o in range(n_obj):
        for g in range(n_grasp):
            aa = rng.randn(3)
            aa = aa / (np.linalg.norm(aa) + 1e-8) * rng.uniform(0, np.pi)
            poses[o, g, :3] = aa
            curl = rng.uniform(0.2, 1.2)
            finger_pose = np.zeros((15, 3), np.float32)
            finger_pose[:, 2] = curl + rng.randn(15) * 0.1
            poses[o, g, 3:] = finger_pose.reshape(-1)
            offset = rng.randn(3)
            offset = offset / (np.linalg.norm(offset) + 1e-8)
            tsls[o, g] = offset * rng.uniform(0.07, 0.12)
    return GraspLibrary(*(torch.as_tensor(a).to(device) for a in (poses, shapes, tsls)))


def get_grasp_library(obj_names: List[str], n_grasp: int, device=None) -> GraspLibrary:
    device = resolve_device(device)
    logger.warning("grasp assets are not ported yet; using the synthetic grasp library")
    return synthetic_grasp_library(len(obj_names), n_grasp, device=device)
