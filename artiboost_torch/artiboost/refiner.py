"""Grasp refiners (counterpart of ``artiboost_tpu/artiboost/refiner.py``;
reference ``anakin/artiboost/refiner.py``): ``null`` (FK only, NullRefine
:118-147) and ``hand_obj``, the iterative RefineNet (:150-285): hand ->
object point distances (``ops/chamfer.py``), a ResBlock MLP predicting a
delta pose (16 x ortho-6D) and a delta translation, contact re-evaluated
at each of ITERS iterations.

RefineNet is the JAX package's re-design (LayerNorm ResBlocks, zero-init
delta heads); GrabNet's ``refinenet.pt`` does not load into it, so the
weights come from the flax params in ``assets/refinenet_tpu.npz``
(``utils/convert.py`` ``refinenet_from_flax``). ``RefinerTrainStep``
trains it (JAX ``make_refiner_train_step``, :158-257) and
``save_refiner_params`` writes that npz
(``python -m artiboost_torch.scripts.train_refiner``)."""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from artiboost_torch.mano.layer import mano_forward, mano_forward_rotmat
from artiboost_torch.mano.model import ManoModel
from artiboost_torch.ops.chamfer import chamfer_distance
from artiboost_torch.utils.misc import asset_path, logger
from artiboost_torch.utils.transform import aa_to_rotmat, rot6d_to_rotmat, rotmat_to_aa

N_VERTS, POSE_6D, H_SIZE = 778, 16 * 6, 512
FALLBACK_WEIGHTS = "assets/refinenet_tpu.npz"


class ResBlock(nn.Module):
    """flax ``ResBlock``: a projection (``Dense_0``, present when fin !=
    fout) and the branch Dense -> LayerNorm -> leaky-ReLU -> Dense ->
    LayerNorm, joined by a leaky-ReLU (slope 0.2). LayerNorm's epsilon is
    flax's 1e-6."""

    def __init__(self, fin: int, fout: int, n_neurons: int = 256):
        super().__init__()
        self.proj = nn.Linear(fin, fout) if fin != fout else None
        self.fc1 = nn.Linear(fin, n_neurons)
        self.ln1 = nn.LayerNorm(n_neurons, eps=1e-6)
        self.fc2 = nn.Linear(n_neurons, fout)
        self.ln2 = nn.LayerNorm(fout, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xin = x if self.proj is None else F.leaky_relu(self.proj(x), 0.2)
        h = F.leaky_relu(self.ln1(self.fc1(x)), 0.2)
        h = self.ln2(self.fc2(h))
        return F.leaky_relu(xin + h, 0.2)


class RefineNet(nn.Module):
    """One refinement step: (h2o_dist (B, 778), pose_6d (B, 96), trans
    (B, 3)) -> (dpose (B, 96), dtrans (B, 3)). The delta heads start at
    zero, so an untrained net is the identity refiner."""

    def __init__(self, h_size: int = H_SIZE):
        super().__init__()
        fin = N_VERTS + POSE_6D + 3
        self.ln0 = nn.LayerNorm(N_VERTS, eps=1e-6)
        self.blocks = nn.ModuleList([ResBlock(fin, h_size), ResBlock(h_size + fin, h_size),
                                     ResBlock(h_size + fin, h_size)])
        self.dpose = nn.Linear(h_size, POSE_6D)
        self.dtrans = nn.Linear(h_size, 3)
        for head in (self.dpose, self.dtrans):
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)

    def forward(self, h2o_dist: torch.Tensor, pose_6d: torch.Tensor, trans: torch.Tensor):
        x0 = torch.cat([self.ln0(h2o_dist), pose_6d, trans], dim=1)
        x = self.blocks[0](x0)
        for block in self.blocks[1:]:
            x = block(torch.cat([x, x0], dim=1))
        return self.dpose(x), self.dtrans(x)


def pose_aa_to_6d(pose_aa: torch.Tensor) -> torch.Tensor:
    """(B, 48) -> (B, 96): per joint the first two rotation-matrix columns."""
    B = pose_aa.shape[0]
    rot = aa_to_rotmat(pose_aa.reshape(B, 16, 3))
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1).reshape(B, POSE_6D)


def pose_6d_to_aa(pose_6d: torch.Tensor) -> torch.Tensor:
    B = pose_6d.shape[0]
    return rotmat_to_aa(rot6d_to_rotmat(pose_6d.reshape(B, 16, 6))).reshape(B, 48)


def _shape_of(feed: Dict) -> torch.Tensor:
    pose = feed["hand_pose"]
    shape = feed.get("hand_shape")
    if shape is None:
        shape = torch.zeros((pose.shape[0], 10), dtype=pose.dtype, device=pose.device)
    return shape


def make_null_refiner(mano_model: ManoModel) -> Callable:
    """fn(feed, obj_verts=None, obj_valid=None) -> refined dict (FK only)."""

    def refine(feed: Dict, obj_verts=None, obj_valid=None) -> Dict:
        pose = feed["hand_pose"]
        out = mano_forward(mano_model, pose, _shape_of(feed))
        tsl = feed["hand_tsl"]
        return {"hand_verts": out.verts + tsl[:, None], "joints": out.joints + tsl[:, None],
                "hand_pose": pose, "hand_tsl": tsl}

    return refine


def make_ho_refiner(mano_model: ManoModel, net: RefineNet, n_iters: int = 3) -> Callable:
    """fn(feed, obj_verts (B, M, 3), obj_valid (B, M)) -> refined dict.
    feed: hand_pose (B, 48), hand_tsl (B, 3), hand_shape (B, 10) optional.
    The object points are already rotated into the hand's frame (reference
    HORefiner :225). Each iteration: FK from the 6D pose, the distance
    sqrt(max(d, 1e-12)) of each hand vertex to its nearest valid object
    point, then pose_6d += dpose and trans += dtrans; FK from the final
    axis-angle pose at the end."""

    @torch.no_grad()
    def refine(feed: Dict, obj_verts: torch.Tensor,
               obj_valid: Optional[torch.Tensor] = None) -> Dict:
        B = feed["hand_pose"].shape[0]
        shape = _shape_of(feed)
        pose_6d, trans = pose_aa_to_6d(feed["hand_pose"]), feed["hand_tsl"]
        for _ in range(n_iters):
            rots = rot6d_to_rotmat(pose_6d.reshape(B, 16, 6))
            verts = mano_forward_rotmat(mano_model, rots, shape).verts + trans[:, None]
            d_xy, _ = chamfer_distance(verts, obj_verts, mask_y=obj_valid)
            dpose, dtrans = net(torch.sqrt(torch.clamp_min(d_xy, 1e-12)), pose_6d, trans)
            pose_6d, trans = pose_6d + dpose, trans + dtrans
        aa = pose_6d_to_aa(pose_6d)
        out = mano_forward(mano_model, aa, shape)
        return {"hand_verts": out.verts + trans[:, None], "joints": out.joints + trans[:, None],
                "hand_pose": aa, "hand_tsl": trans}

    return refine


class RefinerTrainStep:
    """One Adam step (optax.adam: b1 0.9, b2 0.999, eps 1e-8) of the unrolled
    refinement, the JAX package's GrabNet-style recipe: clean grasps under a
    random global rotation (``rotate_hand_global``), their FK and chamfer
    profile, the scrambler's corruption, then ``n_iters`` refinements through
    ``rot6d_to_rotmat`` and ``mano_forward_rotmat``, never ``rotmat_to_aa``,
    whose backward is singular at identity (JAX :218-220). The loss is
    w_verts * the vertices' and w_joints * the joints' mean squared
    recovery plus w_contact * the refined contact profile's squared gap to
    the clean one.

    ``draws(generator, B)`` makes a step's random half: the rotation's axis
    (standard normal (B, 3)) and angle (U(0, 2 pi) (B, 1)) and the
    scrambler's draws; ``step(draws, hand_pose (B, 48), hand_shape (B, 10),
    hand_tsl (B, 3), obj_verts (B, M, 3), obj_valid (B, M))`` -> the
    detached metrics {loss, l_verts, l_joints, l_contact}."""

    def __init__(self, mano_model: ManoModel, net: RefineNet, scrambler, n_iters: int = 3,
                 learning_rate: float = 1e-4, w_verts: float = 1.0, w_joints: float = 1.0,
                 w_contact: float = 0.5):
        self.mano_model, self.net, self.scrambler = mano_model, net, scrambler
        self.n_iters = n_iters
        self.weights = (w_verts, w_joints, w_contact)
        self.optimizer = torch.optim.Adam(net.parameters(), lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def draws(self, generator: torch.Generator, B: int) -> Dict:
        device = next(self.net.parameters()).device
        return {"axis": torch.randn(B, 3, generator=generator, device=device),
                "angle": torch.rand(B, 1, generator=generator, device=device) * (2.0 * math.pi),
                "scram": self.scrambler.draws(generator, B, device)}

    def _h2o(self, verts, obj_verts, obj_valid) -> torch.Tensor:
        d_xy, _ = chamfer_distance(verts, obj_verts, mask_y=obj_valid)
        return torch.sqrt(torch.clamp_min(d_xy, 1e-12))

    def loss(self, draws: Dict, hand_pose, hand_shape, hand_tsl, obj_verts, obj_valid
             ) -> Tuple[torch.Tensor, Dict]:
        from artiboost_torch.artiboost.pose_generator import rotate_hand_global

        mano, B = self.mano_model, hand_pose.shape[0]
        with torch.no_grad():
            axis = draws["axis"] / torch.clamp_min(
                torch.linalg.norm(draws["axis"], dim=-1, keepdim=True), 1e-8)
            rot = aa_to_rotmat(axis * draws["angle"])
            hand_pose, hand_tsl = rotate_hand_global(mano, rot, hand_pose, hand_shape, hand_tsl)
            obj_verts = torch.einsum("bij,bnj->bni", rot, obj_verts)
            clean = mano_forward(mano, hand_pose, hand_shape)
            clean_verts = clean.verts + hand_tsl[:, None]
            clean_joints = clean.joints + hand_tsl[:, None]
            d_clean = self._h2o(clean_verts, obj_verts, obj_valid)
            scram = self.scrambler({"hand_pose": hand_pose, "hand_tsl": hand_tsl,
                                    "joints": clean_joints, "hand_verts": clean_verts,
                                    "hand_transf": clean.transforms_abs}, draws["scram"])
        pose_6d, trans = pose_aa_to_6d(scram["hand_pose"]), scram["hand_tsl"]
        for _ in range(self.n_iters):
            rots = rot6d_to_rotmat(pose_6d.reshape(B, 16, 6))
            verts = mano_forward_rotmat(mano, rots, hand_shape).verts + trans[:, None]
            dpose, dtrans = self.net(self._h2o(verts, obj_verts, obj_valid), pose_6d, trans)
            pose_6d, trans = pose_6d + dpose, trans + dtrans
        out = mano_forward_rotmat(mano, rot6d_to_rotmat(pose_6d.reshape(B, 16, 6)), hand_shape)
        verts, joints = out.verts + trans[:, None], out.joints + trans[:, None]
        d_ref = self._h2o(verts, obj_verts, obj_valid)
        l_verts = torch.mean(torch.sum((verts - clean_verts) ** 2, dim=-1))
        l_joints = torch.mean(torch.sum((joints - clean_joints) ** 2, dim=-1))
        l_contact = torch.mean((d_ref - d_clean) ** 2)
        w_verts, w_joints, w_contact = self.weights
        loss = w_verts * l_verts + w_joints * l_joints + w_contact * l_contact
        return loss, {"loss": loss, "l_verts": l_verts, "l_joints": l_joints,
                      "l_contact": l_contact}

    def __call__(self, draws: Dict, *batch) -> Dict:
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(draws, *batch)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}



def save_refiner_params(net: RefineNet, path: str) -> None:
    """The JAX package's flat npz of RefineNet's flax params ("params/..."
    keys), which ``build_refiner`` here and ``load_refiner_params`` there
    read."""
    from artiboost_torch.utils.convert import refinenet_to_flax, save_flax_npz

    save_flax_npz({"params": refinenet_to_flax(net.state_dict())}, path)


def build_refiner(cfg: Dict, mano_model: ManoModel, device=None) -> Callable:
    """cfg: {"TYPE": "null" | "hand_obj", "ITERS": 3, "PRETRAINED": path}.
    The weights, in the JAX package's order: the configured ``.npz``; else
    ``assets/refinenet_tpu.npz`` when the configured file is absent or
    none is configured; else the identity refiner, with a warning."""
    from artiboost_torch.utils.convert import load_flax_npz, refinenet_from_flax

    kind = cfg.get("TYPE", "null")
    if kind in (None, "null"):
        return make_null_refiner(mano_model)
    if kind != "hand_obj":
        raise ValueError(f"unknown refiner {kind!r}")
    net = RefineNet()
    pretrained = cfg.get("PRETRAINED")
    fallback = asset_path(FALLBACK_WEIGHTS)
    if os.path.isfile(fallback) and (not pretrained or not os.path.isfile(str(pretrained))):
        logger.info(f"refiner: {pretrained or 'no PRETRAINED'} absent; using {fallback}")
        pretrained = fallback
    if pretrained and str(pretrained).endswith(".npz") and os.path.isfile(pretrained):
        loaded = load_flax_npz(pretrained)
        net.load_state_dict(refinenet_from_flax(loaded.get("params", loaded)))
        logger.info(f"refiner: loaded {pretrained}")
    else:
        logger.warning(f"refiner: {pretrained or 'no PRETRAINED'} is not a loadable .npz of "
                       "flax params; starting from the identity refiner")
    net = net.to(mano_model.v_template.device if device is None else device).eval()
    return make_ho_refiner(mano_model, net, n_iters=int(cfg.get("ITERS", 3)))
