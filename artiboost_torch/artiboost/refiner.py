"""Grasp refiners (counterpart of ``artiboost_tpu/artiboost/refiner.py``).
Ported: the ``null`` refiner (FK only, reference NullRefine :118-147).
The ``hand_obj`` refiner with its chamfer term is queued."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from artiboost_torch.mano.layer import mano_forward
from artiboost_torch.mano.model import ManoModel


def make_null_refiner(mano_model: ManoModel) -> Callable:
    """fn(feed, obj_verts=None, obj_valid=None) -> refined dict (FK only)."""

    def refine(feed: Dict, obj_verts=None, obj_valid=None) -> Dict:
        pose = feed["hand_pose"]
        shape = feed.get("hand_shape")
        if shape is None:
            shape = torch.zeros((pose.shape[0], 10), dtype=pose.dtype, device=pose.device)
        out = mano_forward(mano_model, pose, shape)
        tsl = feed["hand_tsl"]
        return {"hand_verts": out.verts + tsl[:, None], "joints": out.joints + tsl[:, None],
                "hand_pose": pose, "hand_tsl": tsl}

    return refine


def build_refiner(cfg: Dict, mano_model: ManoModel) -> Callable:
    kind = cfg.get("TYPE", "null")
    if kind in (None, "null"):
        return make_null_refiner(mano_model)
    raise NotImplementedError(f"refiner {kind!r} is not ported yet; set "
                              "MANAGER.REFINER.TYPE to null")
