"""Pose scramblers (counterpart of ``artiboost_tpu/artiboost/scrambler.py``;
reference ``anakin/artiboost/scrambler.py``). Ported: ``random``, the
axis-angle magnitude noise on all 16 joints plus translation noise
(reference :57-81). ``naive``, ``random_2`` and ``random_3`` are queued."""
from __future__ import annotations

from typing import Dict

import torch

from artiboost_torch.utils.misc import resolve_device


def random_scrambler_draws(generator: torch.Generator, B: int, device=None
                           ) -> Dict[str, torch.Tensor]:
    """Standard-normal draws: translation (B, 3), joint angles (B, 16)."""
    device = resolve_device(device)
    return {"tsl": torch.randn(B, 3, generator=generator, device=device),
            "ang": torch.randn(B, 16, generator=generator, device=device)}


def random_scrambler(feed: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                     tsl_sigma: float, pose_sigma: float) -> Dict[str, torch.Tensor]:
    pose = feed["hand_pose"]
    B = pose.shape[0]
    aa = pose.reshape(B, 16, 3)
    norm = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp_min(norm, 1e-7)
    angle = norm[..., 0] + draws["ang"] * pose_sigma  # may go negative: parity
    return {"hand_pose": (axis * angle[..., None]).reshape(B, 48),
            "hand_tsl": feed["hand_tsl"] + draws["tsl"] * tsl_sigma}


SCRAMBLERS = {"random": (random_scrambler_draws, random_scrambler)}


class Scrambler:
    """cfg {"TYPE", "HAND_TSL_SIGMA", "HAND_POSE_SIGMA"} -> ``draws`` /
    ``__call__`` pair."""

    def __init__(self, cfg: Dict):
        kind = cfg["TYPE"]
        if kind not in SCRAMBLERS:
            raise NotImplementedError(f"scrambler {kind!r} is not ported yet "
                                      f"(ported: {sorted(SCRAMBLERS)})")
        self._draws_fn, self._fn = SCRAMBLERS[kind]
        self.tsl_sigma = float(cfg.get("HAND_TSL_SIGMA", 0.01))
        self.pose_sigma = float(cfg.get("HAND_POSE_SIGMA", 0.1))

    def draws(self, generator: torch.Generator, B: int, device=None):
        device = resolve_device(device)
        return self._draws_fn(generator, B, device)

    def __call__(self, feed, draws):
        return self._fn(feed, draws, self.tsl_sigma, self.pose_sigma)
