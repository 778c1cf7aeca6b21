"""Grasp library as dense (n_obj, n_grasp, ...) tensors (counterpart of
``artiboost_tpu/artiboost/grasp_library.py``; reference
``anakin/artiboost/grasp_engine.py``): per-object lists of (pose 48,
shape 10, tsl 3) MANO grasps, pickled under
``assets/grasp_engine/ycb_grasp/{obj}.pkl``, or a deterministic synthetic
library when those files are absent."""
from __future__ import annotations

import os
import pickle
from typing import List, NamedTuple, Optional

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


def load_grasp_library(obj_names: List[str], grasp_dir: str, n_grasp: int,
                       device=None) -> GraspLibrary:
    """One pickle per object, a list of (pose, shape, tsl); the first
    ``n_grasp`` are kept and a shorter list is repeat-padded. A shape or
    tsl stored as None or a scalar 0 stays zero."""
    device = resolve_device(device)
    poses = np.zeros((len(obj_names), n_grasp, 48), np.float32)
    shapes = np.zeros((len(obj_names), n_grasp, 10), np.float32)
    tsls = np.zeros((len(obj_names), n_grasp, 3), np.float32)
    for i, name in enumerate(obj_names):
        with open(os.path.join(grasp_dir, name + ".pkl"), "rb") as f:
            grasps = pickle.load(f)
        n_have = min(n_grasp, len(grasps))
        for g in range(n_have):
            pose, shape, tsl = grasps[g]
            poses[i, g] = np.asarray(pose, np.float32).reshape(-1)[:48]
            if shape is not None and not (np.isscalar(shape) and not shape):
                shapes[i, g] = np.asarray(shape, np.float32).reshape(-1)[:10]
            if tsl is not None and not (np.isscalar(tsl) and tsl == 0):
                tsls[i, g] = np.asarray(tsl, np.float32).reshape(-1)[:3]
        if n_have < n_grasp:
            reps = np.arange(n_grasp - n_have) % max(n_have, 1)
            poses[i, n_have:] = poses[i, reps]
            shapes[i, n_have:] = shapes[i, reps]
            tsls[i, n_have:] = tsls[i, reps]
    return GraspLibrary(*(torch.as_tensor(a).to(device) for a in (poses, shapes, tsls)))


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


def get_grasp_library(obj_names: List[str], n_grasp: int, grasp_dir: Optional[str] = None,
                      device=None) -> GraspLibrary:
    """The pickled grasps when every object has its file under
    ``grasp_dir`` (default ``assets/grasp_engine/ycb_grasp``), else the
    synthetic library, with a warning."""
    device = resolve_device(device)
    grasp_dir = grasp_dir or "assets/grasp_engine/ycb_grasp"
    if all(os.path.isfile(os.path.join(grasp_dir, n + ".pkl")) for n in obj_names):
        return load_grasp_library(obj_names, grasp_dir, n_grasp, device=device)
    logger.warning("grasp assets not found; using synthetic grasp library")
    return synthetic_grasp_library(len(obj_names), n_grasp, device=device)
