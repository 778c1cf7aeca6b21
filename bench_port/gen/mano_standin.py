"""The MANO stand-in hand, frozen: a deterministic hand with MANO's
published topology (778 vertices, 1538 faces, 16 joints, 10 shape and 45
pose components), written as the official pickle
``<root>/models/MANO_RIGHT.pkl`` so that the program loads it as it
loads the released file. Copied from ``artiboost_torch/mano/model.py``
(``_finger_rest_joints``, ``synthetic_mano_model``)."""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_SHAPE = 10
NUM_POSE_COMPS = 45
# MANO-native order: 0 wrist; 1-3 index; 4-6 middle; 7-9 pinky; 10-12 ring; 13-15 thumb
KINTREE_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)


def _finger_rest_joints() -> np.ndarray:
    j = np.zeros((NUM_JOINTS, 3), dtype=np.float32)
    finger_y = {1: 0.025, 4: 0.008, 7: -0.030, 10: -0.012, 13: 0.045}
    finger_x0 = {1: 0.09, 4: 0.095, 7: 0.080, 10: 0.090, 13: 0.035}
    seg = {1: 0.032, 4: 0.035, 7: 0.026, 10: 0.032, 13: 0.033}
    for base, y in finger_y.items():
        x0, s = finger_x0[base], seg[base]
        for k in range(3):
            j[base + k] = [x0 + s * k, y, 0.0 if base != 13 else -0.01 * (k + 1)]
    return j


def synthetic_mano_arrays(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic stand-in hand with real MANO shapes/topology: vertex
    rings around each bone, nearest-bone LBS weights, official tip ids,
    outward-wound faces padded with degenerate ones to 1538."""
    rng = np.random.RandomState(seed)
    joints = _finger_rest_joints()
    parents = np.array(KINTREE_PARENTS)

    bone_dirs = np.zeros((NUM_JOINTS, 3), dtype=np.float32)
    for jid in range(NUM_JOINTS):
        child = [c for c in range(NUM_JOINTS) if parents[c] == jid]
        if child:
            bone_dirs[jid] = joints[child[0]] - joints[jid]
        else:
            bone_dirs[jid] = joints[jid] - joints[parents[jid]]

    verts = np.zeros((NUM_VERTS, 3), dtype=np.float32)
    weights = np.zeros((NUM_VERTS, NUM_JOINTS), dtype=np.float32)
    per_joint = NUM_VERTS // NUM_JOINTS
    idx = 0
    radius = 0.009
    for jid in range(NUM_JOINTS):
        n = per_joint if jid < NUM_JOINTS - 1 else NUM_VERTS - idx
        t = rng.rand(n).astype(np.float32)
        ang = rng.rand(n).astype(np.float32) * 2 * np.pi
        d = bone_dirs[jid]
        dn = d / (np.linalg.norm(d) + 1e-8)
        ortho1 = np.cross(dn, [0.0, 0.0, 1.0])
        ortho1 /= np.linalg.norm(ortho1) + 1e-8
        ortho2 = np.cross(dn, ortho1)
        pts = (joints[jid][None] + t[:, None] * d[None]
               + radius * (np.cos(ang)[:, None] * ortho1[None]
                           + np.sin(ang)[:, None] * ortho2[None]))
        verts[idx:idx + n] = pts
        w = np.zeros((n, NUM_JOINTS), dtype=np.float32)
        w[:, jid] = 1.0 - 0.3 * t
        if parents[jid] >= 0:
            w[:, parents[jid]] = 0.3 * t
        weights[idx:idx + n] = w
        idx += n
    weights /= weights.sum(1, keepdims=True)

    tip_owner = {745: 15, 317: 3, 444: 6, 556: 12, 673: 9}
    for vid, jid in tip_owner.items():
        verts[vid] = joints[jid] + bone_dirs[jid] * 1.2
        weights[vid] = 0.0
        weights[vid, jid] = 1.0

    J_regressor = np.zeros((NUM_JOINTS, NUM_VERTS), dtype=np.float32)
    for jid in range(NUM_JOINTS):
        dist = np.linalg.norm(verts - joints[jid][None], axis=1)
        nearest = np.argsort(dist)[:8]
        w = np.exp(-dist[nearest] / 0.004)
        J_regressor[jid, nearest] = w / w.sum()

    shapedirs = (rng.randn(NUM_VERTS, 3, NUM_SHAPE) * 0.001).astype(np.float32)
    posedirs = (rng.randn(NUM_VERTS, 3, 9 * (NUM_JOINTS - 1)) * 0.0005).astype(np.float32)
    comps = rng.randn(NUM_POSE_COMPS, NUM_POSE_COMPS).astype(np.float32)
    comps, _ = np.linalg.qr(comps)

    faces = []
    for jid in range(NUM_JOINTS):
        base = jid * per_joint
        n = per_joint if jid < NUM_JOINTS - 1 else NUM_VERTS - base
        for k in range(n - 2):
            faces.append([base + k, base + k + 1, base + k + 2])
        for k in range(n - 3):
            faces.append([base + k, base + k + 2, base + k + 3])
    faces = np.asarray(faces[:1538], dtype=np.int32)
    if faces.shape[0] < 1538:
        faces = np.concatenate([faces, np.zeros((1538 - faces.shape[0], 3), np.int32)])

    fv = verts[faces]
    normal = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    centroid = fv.mean(1)
    nearest = np.argmin(((centroid[:, None, :] - joints[None]) ** 2).sum(-1), axis=1)
    flip = (normal * (centroid - joints[nearest])).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    return {"v_template": verts, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": J_regressor, "weights": weights, "hands_components": comps,
            "hands_mean": np.zeros((NUM_POSE_COMPS,), np.float32),
            "f": faces.astype(np.int64)}


def write_mano_pickle(mano_root: str, seed: int = 0) -> str:
    """The stand-in as ``{mano_root}/models/MANO_RIGHT.pkl`` (the official
    file's keys) -> its path."""
    path = os.path.join(mano_root, "models", "MANO_RIGHT.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(synthetic_mano_arrays(seed), f)
    return path
