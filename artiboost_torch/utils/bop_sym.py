"""BOP object symmetries as padded tensors (counterpart of
``artiboost_tpu/utils/bop_sym.py``; reference
``anakin/utils/bop_toolkit/bop_misc.py:18-66`` and the packing of
``anakin/criterions/symcornerloss.py:23-49``): every object's discrete
and discretised continuous symmetries in one (N, S) table of (R, t,
valid), so the min over symmetries is one masked reduction."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from artiboost_torch.utils.misc import logger
from artiboost_torch.utils.transform import aa_to_rotmat


# HO3D's YCB models live in an OpenGL-flipped frame (reference
# ``anakin/criterions/symcornerloss.py:71-77``)
CAM_EXTR = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))


def _axis_rotmat(angle: float, axis: np.ndarray) -> np.ndarray:
    """Rotation by ``angle`` about ``axis``, through float32 Rodrigues as
    the JAX package computes it."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return aa_to_rotmat(torch.as_tensor(axis * angle, dtype=torch.float32)).numpy()


def get_symmetry_transformations(model_info: Dict, max_sym_disc_step: float = 0.01
                                 ) -> List[Dict]:
    """The identity, the discrete symmetries and the continuous ones
    discretised, each composed with each discrete one."""
    trans_disc = [{"R": np.eye(3), "t": np.zeros((3, 1))}]
    for sym in model_info.get("symmetries_discrete", []):
        sym_4x4 = np.reshape(np.asarray(sym, dtype=np.float64), (4, 4))
        trans_disc.append({"R": sym_4x4[:3, :3], "t": sym_4x4[:3, 3].reshape(3, 1)})
    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64)
        offset = np.asarray(sym["offset"], dtype=np.float64).reshape(3, 1)
        n_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n_steps
        for i in range(1, n_steps):
            R = _axis_rotmat(i * step, axis)
            trans_cont.append({"R": R, "t": -R @ offset + offset})
    out = []
    for td in trans_disc:
        if trans_cont:
            out += [{"R": tc["R"] @ td["R"], "t": tc["R"] @ td["t"] + tc["t"]}
                    for tc in trans_cont]
        else:
            out.append(td)
    return out


def default_ycb_model_info(n_obj: int = 21) -> Dict:
    """Identity-only symmetries for the 21 YCB objects."""
    return {str(i): {} for i in range(1, n_obj + 1)}


def load_model_info(path_or_dict) -> Dict:
    """A models_info dict, its JSON path, or None. An absent path (the
    released configs name ``./assets/extend_models_info.json``, which the
    repository does not hold) degrades to identity symmetries, as the JAX
    package does (``bop_sym.py:69-73``), and says so."""
    if path_or_dict is None:
        return default_ycb_model_info()
    if not isinstance(path_or_dict, str):
        return path_or_dict
    if not os.path.exists(path_or_dict):
        logger.warning(f"MODEL_INFO_PATH {path_or_dict} is absent; the object symmetries are "
                       "identity, as in the JAX package")
        return default_ycb_model_info()
    with open(path_or_dict) as f:
        return json.load(f)


def build_sym_tensor(model_info_path_or_dict, max_sym_disc_step: float = 0.01
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> R (N, S, 3, 3), t (N, S, 3, 1) in metres and valid (N, S), float32,
    for the objects "1".."N"; S is the most symmetries of any object, and
    padding entries are identity with valid 0."""
    model_info = load_model_info(model_info_path_or_dict)
    n_obj = len(model_info)
    syms = [get_symmetry_transformations(model_info[str(i)], max_sym_disc_step)
            for i in range(1, n_obj + 1)]
    S = max(len(s) for s in syms)
    R = np.tile(np.eye(3, dtype=np.float32), (n_obj, S, 1, 1))
    t = np.zeros((n_obj, S, 3, 1), dtype=np.float32)
    valid = np.zeros((n_obj, S), dtype=np.float32)
    for i, s in enumerate(syms):
        for k, tr in enumerate(s):
            R[i, k] = tr["R"].astype(np.float32)
            t[i, k] = tr["t"].astype(np.float32) * 0.001
            valid[i, k] = 1.0
    return R, t, valid


class SymTable:
    """``build_sym_tensor`` as torch tensors, copied once to each device
    asked for; ``gather(obj_idx0)`` -> (R (B, S, 3, 3), t (B, S, 3),
    valid (B, S)) for 0-based object indices."""

    def __init__(self, model_info_path_or_dict, max_sym_disc_step: float = 0.01):
        R, t, valid = build_sym_tensor(model_info_path_or_dict, max_sym_disc_step)
        self.n_obj = R.shape[0]
        self._host = (torch.from_numpy(R), torch.from_numpy(t[..., 0]), torch.from_numpy(valid))
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def gather(self, obj_idx0: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dev = obj_idx0.device
        if dev not in self._on:
            self._on[dev] = tuple(x.to(dev) for x in self._host)
        return tuple(x[obj_idx0] for x in self._on[dev])


def sym_canonical(sym_R: torch.Tensor, sym_t: torch.Tensor, can: torch.Tensor,
                  use_ho3d_ycb: bool) -> torch.Tensor:
    """Canonical points (B, V, 3) under each symmetry (B, S, 3, 3) + (B, S, 3)
    -> (B, S, V, 3); with ``use_ho3d_ycb`` the symmetry acts in the
    flipped frame."""
    if not use_ho3d_ycb:
        return torch.einsum("bsmn,bvn->bsvm", sym_R, can) + sym_t[:, :, None]
    ext = torch.tensor(CAM_EXTR, dtype=can.dtype, device=can.device)
    flipped = torch.einsum("mn,bvn->bvm", ext, can)
    sym_c = torch.einsum("bsmn,bvn->bsvm", sym_R, flipped) + sym_t[:, :, None]
    return torch.einsum("mn,bsvn->bsvm", ext, sym_c)
