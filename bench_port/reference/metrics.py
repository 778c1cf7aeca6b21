"""Plain references of the mining measurement and the reweight: the mean
3D end-point error per sample, BOP's maximum symmetry-aware surface
distance (Hodan et al., "BOP Challenge 2020", ECCV workshops) over the
symmetries a models_info file states, and ArtiBoost's ``method_1``
reweight of the CCV weight map (arXiv:2109.05488, the released
``artiboost_loader.py``)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def epe_mm(pred: torch.Tensor, targ_rel: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) prediction against root-relative targets -> (B,) mean mm."""
    return (pred.double() - (targ_rel.double() + root.double()[:, None])).norm(dim=-1).mean(-1) * 1e3


def _rot(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * (k @ k)


def symmetries(info: Dict, max_step: float = 0.01) -> List[Tuple[np.ndarray, np.ndarray]]:
    """BOP's ``get_symmetry_transformations``: the identity and the discrete
    symmetries, each composed with the continuous ones discretised so that
    no surface point moves more than ``max_step`` of a turn's arc; t in mm."""
    disc = [(np.eye(3), np.zeros(3))]
    for s in info.get("symmetries_discrete", []):
        m = np.asarray(s, np.float64).reshape(4, 4)
        disc.append((m[:3, :3], m[:3, 3]))
    cont = []
    for s in info.get("symmetries_continuous", []):
        n = int(math.ceil(math.pi / max_step))
        off = np.asarray(s["offset"], np.float64)
        for i in range(1, n):
            R = _rot(s["axis"], i * 2.0 * math.pi / n)
            cont.append((R, -R @ off + off))
    if not cont:
        return disc
    return [(Rc @ Rd, Rc @ td + tc) for Rd, td in disc for Rc, tc in cont]


def mssd_mm(pred_rot, pred_tsl, pts_can, obj_transf, syms) -> torch.Tensor:
    """One sample: min over symmetries of the max over ``pts_can`` (N, 3) of
    |T_gt (S x) - T_pred x|, in mm."""
    dev = pts_can.device
    R = torch.as_tensor(np.stack([s[0] for s in syms]), dtype=torch.float64, device=dev)
    t = torch.as_tensor(np.stack([s[1] for s in syms]), dtype=torch.float64, device=dev) * 1e-3
    x = pts_can.double()
    sym_pts = torch.einsum("smn,vn->svm", R, x) + t[:, None]
    Tg = obj_transf.double()
    gt = torch.einsum("mn,svn->svm", Tg[:3, :3], sym_pts) + Tg[:3, 3]
    pr = x @ pred_rot.double().T + pred_tsl.double().reshape(1, 3)
    return (gt - pr[None]).norm(dim=-1).amax(-1).amin() * 1e3


def method_1(weight: torch.Tensor, val_map: torch.Tensor, seen: torch.Tensor,
             lower: float, upper: float) -> torch.Tensor:
    """Each seen triplet's weight times 1 / (confidence + 1/2), confidence
    (max - value) / (max - min + 1e-8) over the seen triplets; clamped."""
    vals = val_map[seen]
    vmin, vmax = vals.min(), vals.max()
    conf = (vmax - val_map) / (vmax - vmin + 1e-8)
    new = torch.where(seen, weight * (1.0 / (conf + 0.5)), weight)
    return torch.clamp(new, lower, upper)
