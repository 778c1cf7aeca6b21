"""Plain MANO forward kinematics (Romero et al., "Embodied Hands", SIGGRAPH
Asia 2017): shape blend, pose blend, the kinematic chain and the joints
with the five fingertip vertices, from the arrays of a MANO pickle. Joint
rotations are Rodrigues' formula of the 16 axis-angle triples."""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIP_VERT_IDS = (745, 317, 444, 556, 673)
# MANO-native (16 joints + 5 tips) -> the 21-keypoint order of the datasets
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


def load_pickle(path: str, device, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    jr = dd["J_regressor"]
    jr = jr.toarray() if hasattr(jr, "toarray") else jr

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
    return {"v_template": t(dd["v_template"]), "shapedirs": t(dd["shapedirs"])[..., :10],
            "posedirs": t(dd["posedirs"]), "J_regressor": t(jr), "weights": t(dd["weights"])}


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    theta = aa.norm(dim=-1, keepdim=True)
    axis = aa / torch.clamp_min(theta, 1e-12)
    kx, ky, kz = axis.unbind(-1)
    zero = torch.zeros_like(kx)
    k = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand_as(k)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return eye + s * k + (1 - c) * (k @ k)


def joints21(mano: Dict[str, torch.Tensor], pose: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
    """pose (B, 48) axis-angle, shape (B, 10) -> joints (B, 21, 3), untranslated."""
    return forward(mano, shape, pose=pose)[1]


def forward(mano: Dict[str, torch.Tensor], shape: torch.Tensor, pose: torch.Tensor = None,
            rots: torch.Tensor = None):
    """FK from an axis-angle ``pose`` (B, 48) or joint rotations ``rots``
    (B, 16, 3, 3), shape (B, 10) -> (verts (B, 778, 3), joints (B, 21, 3)),
    untranslated, in the dtype of the model's arrays."""
    dt = mano["v_template"].dtype
    shape = shape.to(dt)
    B = shape.shape[0]
    rots = rodrigues(pose.to(dt).reshape(B, 16, 3)) if rots is None else rots.to(dt)
    v_shaped = mano["v_template"][None] + torch.einsum("vds,bs->bvd", mano["shapedirs"], shape)
    j_rest = torch.einsum("jv,bvd->bjd", mano["J_regressor"], v_shaped)
    eye = torch.eye(3, dtype=dt, device=shape.device)
    feat = (rots[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", mano["posedirs"], feat)
    glob = []
    for j in range(16):
        local = torch.zeros((B, 4, 4), dtype=dt, device=shape.device)
        local[:, :3, :3] = rots[:, j]
        local[:, :3, 3] = j_rest[:, j] - (j_rest[:, PARENTS[j]] if PARENTS[j] >= 0 else 0.0)
        local[:, 3, 3] = 1.0
        glob.append(local if PARENTS[j] < 0 else glob[PARENTS[j]] @ local)
    G = torch.stack(glob, 1)  # (B, 16, 4, 4)
    joints16 = G[:, :, :3, 3]
    # skinning: each transform acts about its rest joint
    rest = torch.einsum("bjik,bjk->bji", G[:, :, :3, :3], j_rest)
    A = G.clone()
    A[:, :, :3, 3] = G[:, :, :3, 3] - rest
    T = torch.einsum("vj,bjik->bvik", mano["weights"], A)
    verts = torch.einsum("bvik,bvk->bvi", T[..., :3, :3], v_posed) + T[..., :3, 3]
    tips = verts[:, list(TIP_VERT_IDS)]
    return verts, torch.cat([joints16, tips], 1)[:, list(JOINT_REORDER)]


def root_rest(mano: Dict[str, torch.Tensor], shape: torch.Tensor) -> torch.Tensor:
    """The shaped rest position of the root joint (B, 3), the point a global
    rotation of the hand pivots about."""
    dt = mano["v_template"].dtype
    v_shaped = mano["v_template"][None] + torch.einsum("vds,bs->bvd", mano["shapedirs"],
                                                       shape.to(dt))
    return torch.einsum("v,bvd->bd", mano["J_regressor"][0], v_shaped)
