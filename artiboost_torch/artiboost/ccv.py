"""CCV (object x view x grasp) space: dense weight / occurrence /
blacklist maps and triplet sampling (counterpart of
``artiboost_tpu/artiboost/ccv.py``; reference ``ovg_set.py:104-178`` and
the blacklist sweep ``artiboost_loader.py:415-500``)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.transform import aa_to_rotmat


class CCVSpace(NamedTuple):
    sample_weight_map: torch.Tensor  # (O, V, G) f32
    occurrence_map: torch.Tensor     # (O, V, G) int32
    blacklist_map: torch.Tensor      # (O, V, G) f32, 1 = blacklisted

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.sample_weight_map.shape)

    def effective_weights(self) -> torch.Tensor:
        return self.sample_weight_map * (1.0 - self.blacklist_map)


def init_ccv_space(n_obj: int, n_persp: int, n_grasp: int, blacklist_map=None,
                   device=None) -> CCVSpace:
    device = resolve_device(device)
    shape = (n_obj, n_persp, n_grasp)
    if blacklist_map is None:
        blacklist_map = torch.zeros(shape, dtype=torch.float32, device=device)
    return CCVSpace(
        sample_weight_map=torch.ones(shape, dtype=torch.float32, device=device),
        occurrence_map=torch.zeros(shape, dtype=torch.int32, device=device),
        blacklist_map=blacklist_map.to(device),
    )


def flat_to_ovg(flat_id: torch.Tensor, n_persp: int, n_grasp: int):
    """flat id -> (obj, persp, grasp) (reference ovg_set.py:161-170)."""
    obj_id = torch.div(flat_id, n_persp * n_grasp, rounding_mode="floor")
    rem = flat_id % (n_persp * n_grasp)
    return obj_id, torch.div(rem, n_grasp, rounding_mode="floor"), rem % n_grasp


def sample_triplets_draws(space: CCVSpace, generator: torch.Generator, n_samples: int,
                          replace: bool = True) -> torch.Tensor:
    """Random half of the triplet draw -> flat ids (n_samples,).

    With replacement: Categorical(effective weights) (ovg_set.py:113).
    Without: Gumbel top-k over log-weights, the exact equivalent of
    sequential sampling without replacement; ids come in draw order.
    On CUDA ``torch.multinomial`` is not the same bits run to run: from
    equal weights and generator states, ranks on separate cards drew other
    triplets (ROADMAP C.2); under a process group the loader's
    ``DrawSource`` hands every rank rank 0's draw."""
    w = space.effective_weights().reshape(-1)
    logw = torch.log(torch.clamp_min(w, 1e-20))
    if replace:
        return torch.multinomial(torch.exp(logw - logw.max()), n_samples,
                                 replacement=True, generator=generator)
    u = torch.rand(logw.shape, generator=generator, device=logw.device)
    u = torch.clamp(u, torch.finfo(u.dtype).tiny, 1.0)
    g = -torch.log(-torch.log(u))
    return torch.topk(logw + g, n_samples).indices


def triplets_from_flat(space: CCVSpace, flat: torch.Tensor):
    """Deterministic half: flat ids -> (oid, vid, gid, new occurrence map)."""
    _, V, G = space.shape
    oid, vid, gid = flat_to_ovg(flat, V, G)
    occ = space.occurrence_map.clone()
    occ.index_put_((oid, vid, gid), torch.ones_like(oid, dtype=occ.dtype), accumulate=True)
    return oid, vid, gid, occ


def build_blacklist_map(grasp_poses: torch.Tensor, persp_rotmats: torch.Tensor,
                        threshold: float = -0.8) -> torch.Tensor:
    """Hand-back-view filter over the whole space: blacklist (o, v, g)
    when dot(persp^T . R_wrist . back_dir, z) < threshold with back_dir =
    normalized [1.0, 0.2, 0.0] (reference artiboost_loader.py:466-495).

    grasp_poses (O, G, 48), persp_rotmats (V, 3, 3) -> (O, V, G) f32."""
    wrist_rot = aa_to_rotmat(grasp_poses[..., :3])
    back_dir = torch.tensor([1.0, 0.2, 0.0], device=grasp_poses.device)
    back_dir = back_dir / torch.linalg.norm(back_dir)
    back_world = torch.einsum("ogij,j->ogi", wrist_rot, back_dir)
    arrow = torch.einsum("vji,ogj->ovgi", persp_rotmats, back_world)
    return (arrow[..., 2] < threshold).float()
