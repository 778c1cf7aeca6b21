"""Ordinal depth-relation losses, JLOL (counterpart of
``artiboost_tpu/criterions/ordinal.py``; reference
``anakin/criterions/ordinal.py``): for pairs of keypoints (or bone-part
cross products) projected onto the camera ray plus N random virtual view
vectors, penalise predicted orderings whose sign disagrees with the
ground truth.

The random half of each call is split out into ``draws``: the view
vectors (``sample_view_vectors``, :28) and the random 1/3 pair subsample
(``subsample_pairs``, :51).

The pair tables live on the device the draws come from
(``device_constant``), and the draws index them there: moving the draws to
the host would wait on the card every step."""
from __future__ import annotations

from itertools import combinations, product
from typing import Dict, Tuple

import numpy as np
import torch

from artiboost_torch.criterions.criterion import TensorLoss
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.utils.batching import key_validity
from artiboost_torch.utils.misc import CONST, device_constant
from artiboost_torch.utils.registry import LOSS


JOINT_PAIRS = tuple(combinations(range(CONST.NUM_JOINTS), 2))  # (210, 2)
PART_PAIRS = tuple(combinations(range(CONST.NUM_JOINTS - 1), 2))  # (190, 2)
HO_PAIRS = tuple(product(range(CONST.NUM_JOINTS), range(CONST.NUM_CORNERS)))  # (168, 2)


def pair_table(pairs: tuple, device) -> torch.Tensor:
    """(P, 2) int64 index pairs on ``device``."""
    return device_constant(pairs, torch.device(device), torch.int64)


def sample_view_vectors(generator: torch.Generator, n_virtual_views: int, device
                        ) -> torch.Tensor:
    """(NVIEWS + 1, 3): the camera ray, then uniform upper-hemisphere rays."""
    theta = torch.rand(n_virtual_views, generator=generator, device=device) * 2.0 * np.pi
    u = torch.rand(n_virtual_views, generator=generator, device=device)
    s = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    nv = torch.stack([s * torch.cos(theta), s * torch.sin(theta), u], dim=1)
    cam = device_constant(((0.0, 0.0, 1.0),), torch.device(device))
    return torch.cat([cam, nv], dim=0)


def subsample_pairs(generator: torch.Generator, n_pairs: int, device, frac: int = 3
                    ) -> torch.Tensor:
    """n_pairs // frac random pair indices (a fixed count)."""
    perm = torch.randperm(n_pairs, generator=generator, device=device)
    return perm[:max(n_pairs // frac, 1)]


def jointlevel_ordinal_relation(jpair: torch.Tensor, view_vecs: torch.Tensor) -> torch.Tensor:
    """jpair (B, P, 6), view_vecs (V, 3) -> (B, P, V) signed depth order."""
    return torch.einsum("bpk,vk->bpv", jpair[..., :3] - jpair[..., 3:], view_vecs)


def partlevel_ordinal_relation(ppair: torch.Tensor, view_vecs: torch.Tensor) -> torch.Tensor:
    """ppair (B, P, 6) bone-vector pairs -> (B, P, V) via the cross product."""
    cross = torch.linalg.cross(ppair[..., :3], ppair[..., 3:], dim=-1)
    return torch.einsum("bpk,vk->bpv", cross, view_vecs)


def _mask_kp(kp: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    return kp * vis[..., None]


@LOSS.register_module
class HandOrdLoss(TensorLoss):
    def __init__(self, LAMBDA_PART_LEVEL: float = 1.0, LAMBDA_JOINTS_LEVEL: float = 1.0,
                 N_VIRTUAL_VIEWS: int = 20, **_):
        super().__init__()
        self.lambda_part_lev = float(LAMBDA_PART_LEVEL)
        self.lambda_joint_lev = float(LAMBDA_JOINTS_LEVEL)
        self.n_virtual_views = int(N_VIRTUAL_VIEWS)
        self.joint_pairs_idx = torch.tensor(JOINT_PAIRS)
        self.parts_pairs_idx = torch.tensor(PART_PAIRS)

    def draws(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        return {"view": sample_view_vectors(generator, self.n_virtual_views, device),
                "sel_j": subsample_pairs(generator, len(self.joint_pairs_idx), device),
                "sel_p": subsample_pairs(generator, len(self.parts_pairs_idx), device)}

    def _pairs(self, kp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        idx = idx.to(kp.device)
        return torch.cat([kp[:, idx[:, 0]], kp[:, idx[:, 1]]], dim=2)

    def _parts(self, joints: torch.Tensor) -> torch.Tensor:
        parents = device_constant(tuple(CONST.JOINTS_IDX_PARENTS), joints.device, torch.int64)
        return (joints - joints[:, parents])[:, 1:]  # (B, 20, 3)

    def __call__(self, preds: Dict, targs: Dict, draws: Dict) -> Tuple[torch.Tensor, Dict]:
        vis = targs[Queries.JOINTS_VIS]
        m = key_validity(targs, Queries.JOINTS_3D, Queries.ROOT_JOINT)
        if m is not None:  # union batch: zeroed joints give targ sign 0 -> no loss
            vis = vis * m[:, None]
        pred_j = _mask_kp(preds["joints_3d_abs"], vis)
        targ_j = _mask_kp(targs[Queries.JOINTS_3D] + targs[Queries.ROOT_JOINT][:, None], vis)
        view = draws["view"]

        sel_j, sel_p = draws["sel_j"], draws["sel_p"]
        jidx = pair_table(JOINT_PAIRS, sel_j.device)[sel_j]
        targ_sign = torch.sign(jointlevel_ordinal_relation(self._pairs(targ_j, jidx), view))
        pred_ord = jointlevel_ordinal_relation(self._pairs(pred_j, jidx), view)
        joint_ord_loss = torch.mean(torch.log1p(torch.relu(-targ_sign * pred_ord)))

        # part level (no log in the reference for parts)
        pidx = pair_table(PART_PAIRS, sel_p.device)[sel_p]
        targ_psign = torch.sign(partlevel_ordinal_relation(
            self._pairs(self._parts(targ_j), pidx), view))
        pred_pord = partlevel_ordinal_relation(self._pairs(self._parts(pred_j), pidx), view)
        part_ord_loss = torch.mean(torch.relu(-targ_psign * pred_pord))

        final_loss = self.lambda_joint_lev * joint_ord_loss + self.lambda_part_lev * part_ord_loss
        return final_loss, {"joint_ord_loss": joint_ord_loss, "part_ord_loss": part_ord_loss,
                            self.output_key: final_loss}


@LOSS.register_module
class SceneOrdLoss(TensorLoss):
    def __init__(self, LAMBDA_SCENE_LEVEL: float = 1.0, N_VIRTUAL_VIEWS: int = 40, **_):
        super().__init__()
        self.lambda_scene_lev = float(LAMBDA_SCENE_LEVEL)
        self.n_virtual_views = int(N_VIRTUAL_VIEWS)
        self.ho_pairs_idx = torch.tensor(HO_PAIRS)

    def draws(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        return {"view": sample_view_vectors(generator, self.n_virtual_views, device),
                "sel": subsample_pairs(generator, len(self.ho_pairs_idx), device)}

    def __call__(self, preds: Dict, targs: Dict, draws: Dict) -> Tuple[torch.Tensor, Dict]:
        root = targs[Queries.ROOT_JOINT][:, None]
        j_vis, c_vis = targs[Queries.JOINTS_VIS], targs[Queries.CORNERS_VIS]
        mj = key_validity(targs, Queries.JOINTS_3D, Queries.ROOT_JOINT)
        mc = key_validity(targs, Queries.CORNERS_3D, Queries.ROOT_JOINT)
        if mj is not None:
            j_vis = j_vis * mj[:, None]
        if mc is not None:
            c_vis = c_vis * mc[:, None]
        pred_j = _mask_kp(preds["joints_3d_abs"], j_vis)
        targ_j = _mask_kp(targs[Queries.JOINTS_3D] + root, j_vis)
        pred_c = _mask_kp(preds["corners_3d_abs"], c_vis)
        targ_c = _mask_kp(targs[Queries.CORNERS_3D] + root, c_vis)

        sel = draws["sel"]
        p = pair_table(HO_PAIRS, sel.device)[sel].to(pred_j.device)
        pred_pairs = torch.cat([pred_j[:, p[:, 0]], pred_c[:, p[:, 1]]], dim=2)
        targ_pairs = torch.cat([targ_j[:, p[:, 0]], targ_c[:, p[:, 1]]], dim=2)
        targ_sign = torch.sign(jointlevel_ordinal_relation(targ_pairs, draws["view"]))
        pred_ord = jointlevel_ordinal_relation(pred_pairs, draws["view"])
        scene_ord_loss = torch.mean(torch.log1p(torch.relu(-targ_sign * pred_ord)))
        final_loss = self.lambda_scene_lev * scene_ord_loss
        return final_loss, {"scene_ord_loss": scene_ord_loss, self.output_key: final_loss}
