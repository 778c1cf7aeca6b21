"""Viewpoint discretization + sampling (counterpart of
``artiboost_tpu/artiboost/view_engine.py``; reference
``anakin/artiboost/view_engine.py``): the view sphere is binned by
u in [-1, 1] x theta in [0, 2pi); a view id maps to its bin center,
jittered within the bin; the camera gets a random roll and z offset."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.transform import align_vector_to_z


class ViewEngineConfig(NamedTuple):
    persp_u_bins: int = 12
    persp_theta_bins: int = 24
    camera_z_min: float = 0.45
    camera_z_max: float = 0.55

    @property
    def n_persp(self) -> int:
        return self.persp_u_bins * self.persp_theta_bins


def _bin_centers(cfg: ViewEngineConfig, persp_id: torch.Tensor):
    u_id = torch.div(persp_id, cfg.persp_theta_bins, rounding_mode="floor")
    theta_id = persp_id % cfg.persp_theta_bins
    u_unit = 2.0 / cfg.persp_u_bins
    theta_unit = 2.0 * math.pi / cfg.persp_theta_bins
    u_center = (-1.0 + u_unit / 2.0) + u_id.float() * u_unit
    theta_center = theta_unit / 2.0 + theta_id.float() * theta_unit
    return u_center, theta_center, u_unit, theta_unit


def _direction_rotmat(u: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    s = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    target = torch.stack([s * torch.cos(theta), s * torch.sin(theta), u], dim=-1)
    return align_vector_to_z(target)


def persp_rotmat_centers(cfg: ViewEngineConfig, device=None) -> torch.Tensor:
    """(n_persp, 3, 3) exact bin-center rotations (blacklist sweep)."""
    device = resolve_device(device)
    u, theta, _, _ = _bin_centers(cfg, torch.arange(cfg.n_persp, device=device))
    return _direction_rotmat(u, theta)


def sample_view_draws(generator: torch.Generator, B: int, cfg: ViewEngineConfig,
                      device=None) -> Dict[str, torch.Tensor]:
    """Random half of ``sample_view``: intra-bin jitter (u, theta) and roll
    as U(0, 1), camera z as U(z_min, z_max), each (B,)."""
    device = resolve_device(device)
    u = torch.rand(B, generator=generator, device=device)
    theta = torch.rand(B, generator=generator, device=device)
    roll = torch.rand(B, generator=generator, device=device)
    z = torch.rand(B, generator=generator, device=device)
    z = z * (cfg.camera_z_max - cfg.camera_z_min) + cfg.camera_z_min
    return {"u": u, "theta": theta, "roll": roll, "z": z}


def sample_view(cfg: ViewEngineConfig, persp_id: torch.Tensor,
                draws: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (persp_rotmat (B, 3, 3), camera_free_rotmat (B, 3, 3), z_offset (B, 3))."""
    u_center, theta_center, u_unit, theta_unit = _bin_centers(cfg, persp_id)
    u = torch.clamp(u_center + (draws["u"] - 0.5) * u_unit, -1.0, 1.0)
    theta = torch.clamp(theta_center + (draws["theta"] - 0.5) * theta_unit,
                        0.0, 2.0 * math.pi)
    persp = _direction_rotmat(u, theta)
    roll = draws["roll"] * 2.0 * math.pi
    c, s = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    cam_free = torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    z = draws["z"]
    z_offset = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
    return persp, cam_free, z_offset
