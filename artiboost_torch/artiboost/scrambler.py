"""Pose scramblers (counterpart of ``artiboost_tpu/artiboost/scrambler.py``;
reference ``anakin/artiboost/scrambler.py``): ``naive``, translation noise
only (reference :38-54); ``random``, the axis-angle magnitude noise on all
16 joints plus translation noise (reference :57-81); ``random_2``, the
anatomically-aware splay of the four finger MCPs about their up axes and
an interlinked bend of each finger about its left axis (reference
:84-189); ``random_3``, the same splay and an independent bend of every
finger joint (reference :192-260). The last two read the joint axes of
``mano/axis_layer.py`` from the feed's ``joints`` and ``hand_transf``."""
from __future__ import annotations

from typing import Dict

import torch

from artiboost_torch.mano.axis_layer import hand_axes
from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.transform import aa_to_rotmat, rotmat_to_aa


def naive_scrambler_draws(generator: torch.Generator, B: int, device=None
                          ) -> Dict[str, torch.Tensor]:
    """Standard-normal translation draws (B, 3)."""
    device = resolve_device(device)
    return {"tsl": torch.randn(B, 3, generator=generator, device=device)}


def naive_scrambler(feed: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                    tsl_sigma: float, pose_sigma: float) -> Dict[str, torch.Tensor]:
    return {"hand_pose": feed["hand_pose"], "hand_tsl": feed["hand_tsl"] + draws["tsl"] * tsl_sigma}


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


def axis_angle_op(aa_1: torch.Tensor, aa_2: torch.Tensor) -> torch.Tensor:
    """Compose two (B, J, 3) axis-angle rotations: R(aa_1) @ R(aa_2)."""
    return rotmat_to_aa(aa_to_rotmat(aa_1) @ aa_to_rotmat(aa_2))


# axis-layer rows 0..14 are the articulated joints 1..15: index (1, 2, 3),
# middle (4, 5, 6), pinky (7, 8, 9), ring (10, 11, 12), thumb (13, 14, 15)
_SPLAY_ROWS, _SPLAY_JOINTS = [0, 3, 6, 9], [1, 4, 7, 10]
_INTERLINK = (1.0, 1.1, 0.9)
_FINGER_ROWS = ((0, 1, 2), (3, 4, 5), (9, 10, 11), (6, 7, 8))  # index, middle, ring, pinky
_FINGER_JOINTS = ((1, 2, 3), (4, 5, 6), (10, 11, 12), (7, 8, 9))
_BEND_ROWS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14]
_BEND_JOINTS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15]


def _anatomic_draws(generator: torch.Generator, B: int, n_bend: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Standard-normal draws in JAX's ``split(key, 4)`` order: translation
    (B, 3), MCP splay (B, 4), bend (B, n_bend), thumb CMC bend and splay
    (B, 2)."""
    device = resolve_device(device)
    return {k: torch.randn(B, n, generator=generator, device=device)
            for k, n in (("tsl", 3), ("splay", 4), ("bend", n_bend), ("other", 2))}


def random_2_scrambler_draws(generator: torch.Generator, B: int, device=None):
    return _anatomic_draws(generator, B, 5, device)


def random_3_scrambler_draws(generator: torch.Generator, B: int, device=None):
    return _anatomic_draws(generator, B, 14, device)


def _splay(pose: torch.Tensor, u_ax: torch.Tensor, splay: torch.Tensor) -> torch.Tensor:
    """The four finger MCPs splayed about their up axes (applied after the
    joint's own rotation)."""
    pose = pose.clone()
    aa = u_ax[:, _SPLAY_ROWS] * splay[..., None]
    pose[:, _SPLAY_JOINTS] = axis_angle_op(pose[:, _SPLAY_JOINTS], aa)
    return pose


def _thumb_cmc(pose: torch.Tensor, u_ax: torch.Tensor, l_ax: torch.Tensor,
               other: torch.Tensor) -> torch.Tensor:
    """The thumb CMC (joint 13, axis row 12): bend, then splay."""
    pose = pose.clone()
    bend_aa = l_ax[:, 12:13] * other[:, 0:1, None]
    splay_aa = u_ax[:, 12:13] * other[:, 1:2, None]
    pose[:, 13:14] = axis_angle_op(splay_aa, axis_angle_op(bend_aa, pose[:, 13:14]))
    return pose


def random_2_scrambler(feed: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                       tsl_sigma: float, pose_sigma: float) -> Dict[str, torch.Tensor]:
    pose = feed["hand_pose"]
    B = pose.shape[0]
    _, u_ax, l_ax = hand_axes(feed["joints"], feed["hand_transf"])
    hand_pose = _splay(pose.reshape(B, 16, 3), u_ax, draws["splay"] * pose_sigma)
    bend = draws["bend"] * pose_sigma  # one angle per finger
    interlink = torch.tensor(_INTERLINK, dtype=pose.dtype, device=pose.device)
    for fi, (rows, joints) in enumerate(zip(_FINGER_ROWS, _FINGER_JOINTS)):
        aa = l_ax[:, list(rows)] * (bend[:, fi:fi + 1] * interlink)[..., None]
        hand_pose[:, list(joints)] = axis_angle_op(aa, hand_pose[:, list(joints)])
    # thumb: joints 14, 15 about rows 13, 14, interlinked (1.0, 0.9)
    aa = l_ax[:, [13, 14]] * (bend[:, 4:5] * interlink[[0, 2]])[..., None]
    hand_pose[:, [14, 15]] = axis_angle_op(aa, hand_pose[:, [14, 15]])
    hand_pose = _thumb_cmc(hand_pose, u_ax, l_ax, draws["other"] * pose_sigma)
    return {"hand_pose": hand_pose.reshape(B, 48),
            "hand_tsl": feed["hand_tsl"] + draws["tsl"] * tsl_sigma}


def random_3_scrambler(feed: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                       tsl_sigma: float, pose_sigma: float) -> Dict[str, torch.Tensor]:
    pose = feed["hand_pose"]
    B = pose.shape[0]
    _, u_ax, l_ax = hand_axes(feed["joints"], feed["hand_transf"])
    hand_pose = _splay(pose.reshape(B, 16, 3), u_ax, draws["splay"] * pose_sigma)
    aa = l_ax[:, _BEND_ROWS] * (draws["bend"] * pose_sigma)[..., None]
    hand_pose[:, _BEND_JOINTS] = axis_angle_op(aa, hand_pose[:, _BEND_JOINTS])
    hand_pose = _thumb_cmc(hand_pose, u_ax, l_ax, draws["other"] * pose_sigma)
    return {"hand_pose": hand_pose.reshape(B, 48),
            "hand_tsl": feed["hand_tsl"] + draws["tsl"] * tsl_sigma}


SCRAMBLERS = {"naive": (naive_scrambler_draws, naive_scrambler),
              "random": (random_scrambler_draws, random_scrambler),
              "random_2": (random_2_scrambler_draws, random_2_scrambler),
              "random_3": (random_3_scrambler_draws, random_3_scrambler)}


class Scrambler:
    """cfg {"TYPE", "HAND_TSL_SIGMA", "HAND_POSE_SIGMA"} -> ``draws`` /
    ``__call__`` pair."""

    def __init__(self, cfg: Dict):
        kind = cfg["TYPE"]
        if kind not in SCRAMBLERS:
            raise ValueError(f"unknown scrambler {kind!r} (choices: {sorted(SCRAMBLERS)})")
        self._draws_fn, self._fn = SCRAMBLERS[kind]
        self.tsl_sigma = float(cfg.get("HAND_TSL_SIGMA", 0.01))
        self.pose_sigma = float(cfg.get("HAND_POSE_SIGMA", 0.1))

    def draws(self, generator: torch.Generator, B: int, device=None):
        device = resolve_device(device)
        return self._draws_fn(generator, B, device)

    def __call__(self, feed, draws):
        return self._fn(feed, draws, self.tsl_sigma, self.pose_sigma)
