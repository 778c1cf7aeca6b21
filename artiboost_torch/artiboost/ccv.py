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


# resolution of the fixed-point weights of the draw with replacement: a
# weight becomes floor(w / max(w) * 2^FIXED_POINT_BITS), fewer bits where
# the cells' sum would pass 2^62
FIXED_POINT_BITS = 40


def fixed_point_weights(w: torch.Tensor) -> torch.Tensor:
    """(N,) float weights >= 0 -> (N,) int64 floor(w / max(w) * 2^bits).
    The max is exact in any order, and float64's division and the power of
    two are correctly rounded on every device, so the integers depend only
    on the weights' bits. A weight of 0, or one below 2^-bits of the
    largest, becomes 0."""
    bits = min(FIXED_POINT_BITS, 62 - max(int(w.numel()), 1).bit_length())
    w = w.double()
    return torch.floor(w / w.max() * 2.0 ** bits).to(torch.int64)


def sample_triplets_draws(space: CCVSpace, generator: torch.Generator, n_samples: int,
                          replace: bool = True) -> torch.Tensor:
    """Random half of the triplet draw -> flat ids (n_samples,).

    With replacement: Categorical(effective weights) (ovg_set.py:113), by
    the inverse CDF over ``fixed_point_weights``: their prefix sums are
    int64, exact and so the same bits in any order of the scan; ``n_samples``
    float64 uniforms from ``generator``, scaled to [0, total), are looked
    up in them (``searchsorted``). So the ids depend only on the weights'
    bits and the generator's state, in any process and on any card, and
    one algorithm runs on the CPU and the card. A cell of weight 0
    (blacklisted, or below the fixed point's resolution) is never drawn;
    at least one weight must be positive. JAX draws by a threefry Gumbel-max
    (``jax.random.categorical``): the same distribution, not its bits.
    Without replacement: Gumbel top-k over log-weights, the exact
    equivalent of sequential sampling without replacement; ids come in
    draw order."""
    w = space.effective_weights().reshape(-1)
    if replace:
        cdf = torch.cumsum(fixed_point_weights(w), 0)
        u = torch.rand(n_samples, generator=generator, device=w.device, dtype=torch.float64)
        r = torch.minimum(torch.floor(u * cdf[-1].double()).to(torch.int64), cdf[-1] - 1)
        return torch.searchsorted(cdf, r, right=True)
    logw = torch.log(torch.clamp_min(w, 1e-20))
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
