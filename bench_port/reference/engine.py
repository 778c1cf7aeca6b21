"""The plain reference of ArtiBoost's pose engine (Yang et al., "ArtiBoost",
CVPR 2022, Sec. 3.2-3.3), from the asset files and the draws of one pose
chunk: each (object, view, grasp) triplet's grasp under the view's rotation
about the hand's root, the camera offset that puts the middle finger's
knuckle half-way to the object's centre, the camera's roll and distance,
the ``random`` scrambler's noise on every joint angle and on the
translation, then the refiner's iterations (RefineNet on each hand
vertex's distance to its nearest object point), and the final hand in the
camera frame.

The object points are the meshes' vertices in the dataset's frame (HO3D's
is flipped in y and z), centred on their bounding box and, above 2,048
vertices, thinned to 2,048 at even strides, as the released preprocessing
keeps them; the bounding box's corners are the object's corners. RefineNet's
weights are read from the same ``.npz`` the program loads. Everything is
computed in ``dtype`` (float64 for the check, bfloat16 for the control)."""
from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import mano as ref_mano

HO3D_FLIP = np.diag([1.0, -1.0, -1.0])
MAX_OBJ_VERTS = 2048


def read_obj_verts(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([[float(x) for x in line.split()[1:4]] for line in f
                         if line.startswith("v ")], np.float64)


def load_objects(root: str, names: List[str], dataset_type: str, device) -> Dict:
    """-> {"verts" (n, V, 3) zero-padded, "valid" (n, V), "corners" (n, 8, 3)}
    in float64 from ``<root>/<name>/ds_textured.obj``."""
    meshes, corners = [], []
    for name in names:
        v = read_obj_verts(os.path.join(root, name, "ds_textured.obj"))
        if dataset_type == "HO3D":
            v = v @ HO3D_FLIP.T
        v = v - (v.min(0) + v.max(0)) / 2
        if v.shape[0] > MAX_OBJ_VERTS:
            v = v[np.linspace(0, v.shape[0] - 1, MAX_OBJ_VERTS).astype(np.int64)]
        lo, hi = v.min(0), v.max(0)
        corners.append([[(lo, hi)[a][0], (lo, hi)[b][1], (lo, hi)[c][2]]
                        for a in (0, 1) for b in (0, 1) for c in (0, 1)])
        meshes.append(v)
    n_max = max(v.shape[0] for v in meshes)
    verts = np.zeros((len(meshes), n_max, 3))
    valid = np.zeros((len(meshes), n_max))
    for i, v in enumerate(meshes):
        verts[i, :v.shape[0]], valid[i, :v.shape[0]] = v, 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)  # noqa: E731
    return {"verts": t(verts), "valid": t(valid), "corners": t(corners)}


def load_grasps(grasp_dir: str, names: List[str], n_grasp: int, device) -> Dict:
    """The first ``n_grasp`` (pose, shape, translation) grasps of each
    object's pickle, a shorter list repeated from its start."""
    out = {"pose": np.zeros((len(names), n_grasp, 48)), "shape": np.zeros((len(names), n_grasp, 10)),
           "tsl": np.zeros((len(names), n_grasp, 3))}
    for i, name in enumerate(names):
        with open(os.path.join(grasp_dir, name + ".pkl"), "rb") as f:
            grasps = pickle.load(f)
        for g in range(n_grasp):
            pose, shape, tsl = grasps[g % len(grasps)]
            out["pose"][i, g] = np.asarray(pose, np.float64).reshape(-1)[:48]
            if shape is not None and np.size(shape) > 1:
                out["shape"][i, g] = np.asarray(shape, np.float64).reshape(-1)[:10]
            if tsl is not None and np.size(tsl) > 1:
                out["tsl"][i, g] = np.asarray(tsl, np.float64).reshape(-1)[:3]
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def load_refinenet(path: str, device) -> Dict[str, torch.Tensor]:
    with np.load(path) as blob:
        return {k: torch.as_tensor(blob[k], dtype=torch.float64, device=device)
                for k in blob.files}


def rot_to_aa(R: torch.Tensor) -> torch.Tensor:
    """A rotation's axis-angle with its angle in [0, pi]: the quaternion of
    the largest of its four components (Shepperd), turned to w >= 0."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    sq = torch.stack([1 + m[0][0] + m[1][1] + m[2][2], 1 + m[0][0] - m[1][1] - m[2][2],
                      1 - m[0][0] + m[1][1] - m[2][2], 1 - m[0][0] - m[1][1] + m[2][2]], -1)
    big = torch.sqrt(torch.clamp_min(sq, 0.0)) / 2
    a, b, c = m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]
    e, f, g = m[0][1] + m[1][0], m[0][2] + m[2][0], m[1][2] + m[2][1]
    q = [big[..., 0], big[..., 1], big[..., 2], big[..., 3]]
    d = [4 * torch.clamp_min(x, 1e-30) for x in q]
    cands = torch.stack([torch.stack([q[0], a / d[0], b / d[0], c / d[0]], -1),
                         torch.stack([a / d[1], q[1], e / d[1], f / d[1]], -1),
                         torch.stack([b / d[2], e / d[2], q[2], g / d[2]], -1),
                         torch.stack([c / d[3], f / d[3], g / d[3], q[3]], -1)], -2)
    best = big.argmax(-1)[..., None, None].expand(big.shape[:-1] + (1, 4))
    quat = torch.gather(cands, -2, best)[..., 0, :]
    quat = quat * torch.where(quat[..., :1] < 0, -1.0, 1.0).to(quat.dtype)
    s = quat[..., 1:].norm(dim=-1, keepdim=True)
    return quat[..., 1:] / torch.clamp_min(s, 1e-30) * 2 * torch.atan2(s, quat[..., :1])


def z_to(vec: torch.Tensor) -> torch.Tensor:
    """The rotation that takes the z axis onto the unit vector ``vec`` by the
    shortest arc (a half turn about x where they are opposite)."""
    c = vec[..., 2]
    kx, ky = -vec[..., 1], vec[..., 0]  # z x vec
    zero = torch.zeros_like(c)
    K = torch.stack([zero, zero, ky, zero, zero, -kx, -ky, kx, zero], -1).reshape(c.shape + (3, 3))
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand_as(K)
    R = eye + K + K @ K / torch.clamp_min(1.0 + c, 1e-6)[..., None, None]
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=vec.dtype, device=vec.device))
    return torch.where((c < -1.0 + 1e-6)[..., None, None], flip.expand_as(K), R)


def rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(a.shape + (3, 3))


def view(persp_id: torch.Tensor, d: Dict, cfg: Dict, dt) -> Dict:
    """The view's rotation (the camera direction of the jittered bin on the
    u x theta sphere), the camera's roll and its offset along z. ``d``: the
    draws in [0, 1) of the jitter and the roll, and the distance as drawn."""
    nu, nt = int(cfg["PERSP_U_BINS"]), int(cfg["PERSP_THETA_BINS"])
    du, dth = 2.0 / nu, 2 * math.pi / nt
    iu, it = (persp_id // nt).to(dt), (persp_id % nt).to(dt)
    u = torch.clamp(-1.0 + (iu + d["u"].to(dt)) * du, -1.0, 1.0)
    th = torch.clamp((it + d["theta"].to(dt)) * dth, 0.0, 2 * math.pi)
    s = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    persp = z_to(torch.stack([s * torch.cos(th), s * torch.sin(th), u], -1))
    z = d["z"].to(dt)  # drawn in CAMERA_Z_RANGE
    return {"persp": persp, "roll": rot_z(d["roll"].to(dt) * 2 * math.pi),
            "z": torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)}


def rotate_about_root(mano: Dict, rot, pose, shape, tsl):
    """The same hand turned by ``rot`` about the camera's origin, as a MANO
    pose and translation: -> (pose, tsl)."""
    R0 = ref_mano.rodrigues(pose[:, :3])
    R1 = rot @ R0
    center = ref_mano.root_rest(mano, shape)
    new_pose = torch.cat([rot_to_aa(R1), pose[:, 3:]], 1)
    off0 = center - (R0 @ center[..., None])[..., 0]
    off1 = center - (R1 @ center[..., None])[..., 0]
    return new_pose, (rot @ (off0 + tsl)[..., None])[..., 0] - off1


def scramble_random(pose, tsl, d: Dict, cfg: Dict):
    """Every joint's angle moved by HAND_POSE_SIGMA x a normal draw (about
    its own axis, through zero), the translation by HAND_TSL_SIGMA x one."""
    B = pose.shape[0]
    aa = pose.reshape(B, 16, 3)
    n = aa.norm(dim=-1, keepdim=True)
    ang = n[..., 0] + d["ang"].to(pose.dtype) * float(cfg["HAND_POSE_SIGMA"])
    return ((aa / torch.clamp_min(n, 1e-7)) * ang[..., None]).reshape(B, 48), \
        tsl + d["tsl"].to(pose.dtype) * float(cfg["HAND_TSL_SIGMA"])


def refinenet(p: Dict, dist, pose6, trans):
    def dense(x, k):
        return x @ p[k + "/kernel"] + p[k + "/bias"]

    def ln(x, k):
        return F.layer_norm(x, x.shape[-1:], p[k + "/scale"], p[k + "/bias"], eps=1e-6)

    def block(x, k):
        n = sum(1 for name in p if name.startswith(k + "/Dense_") and name.endswith("/kernel"))
        skip = F.leaky_relu(dense(x, k + "/Dense_0"), 0.2) if n == 3 else x
        h = F.leaky_relu(ln(dense(x, f"{k}/Dense_{n - 2}"), k + "/LayerNorm_0"), 0.2)
        return F.leaky_relu(skip + ln(dense(h, f"{k}/Dense_{n - 1}"), k + "/LayerNorm_1"), 0.2)

    x0 = torch.cat([ln(dist, "params/LayerNorm_0"), pose6, trans], 1)
    x = block(x0, "params/ResBlock_0")
    k = 1
    while f"params/ResBlock_{k}/Dense_1/kernel" in p:
        x = block(torch.cat([x, x0], 1), f"params/ResBlock_{k}")
        k += 1
    return dense(x, "params/Dense_0"), dense(x, "params/Dense_1")


def six_to_rot(d6):
    a, b = d6[..., :3], d6[..., 3:]
    x = a / torch.clamp_min(a.norm(dim=-1, keepdim=True), 1e-8)
    z = torch.linalg.cross(x, b, dim=-1)
    z = z / torch.clamp_min(z.norm(dim=-1, keepdim=True), 1e-8)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], -1)


def refine(mano, net, pose, shape, tsl, obj_pts, obj_valid, iters: int):
    """-> (joint rotations (B, 16, 3, 3), translation) after ``iters`` steps."""
    B = pose.shape[0]
    R = ref_mano.rodrigues(pose.reshape(B, 16, 3))
    pose6 = torch.cat([R[..., :, 0], R[..., :, 1]], -1).reshape(B, 96)
    for _ in range(iters):
        verts, _ = ref_mano.forward(mano, shape, rots=six_to_rot(pose6.reshape(B, 16, 6)))
        verts = verts + tsl[:, None]
        d = ((verts[:, :, None] - obj_pts[:, None]) ** 2).sum(-1)
        d = torch.where(obj_valid[:, None] > 0, d, torch.full_like(d, float("inf"))).amin(2)
        dpose, dtsl = refinenet(net, torch.sqrt(torch.clamp_min(d, 1e-12)), pose6, tsl)
        pose6, tsl = pose6 + dpose, tsl + dtsl
    return six_to_rot(pose6.reshape(B, 16, 6)), tsl


def generate(data: Dict, cfg: Dict, oid, vid, gid, draws: Dict, dt) -> Dict:
    """One chunk's rows -> {"joints" (B, 21, 3) the final hand in the camera
    frame, "corners" (B, 8, 3) the object's}. ``data``: the loaded objects,
    grasps, MANO arrays and RefineNet weights; ``cfg``: the recipe's MANAGER."""
    c = lambda t: t.to(dt)  # noqa: E731
    mano = {k: c(v) for k, v in data["mano"].items()}
    net = {k: c(v) for k, v in data["net"].items()}
    pose, shape, tsl = (c(data["grasps"][k][oid, gid]) for k in ("pose", "shape", "tsl"))
    _, joints = ref_mano.forward(mano, shape, pose=pose)
    joints = joints + tsl[:, None]
    v = view(vid, draws["view"], cfg["VIEW_ENGINE"], dt)
    inv = v["persp"].transpose(1, 2)
    cam_offset = v["z"] - (inv @ joints[:, 9, :, None])[..., 0] / 2
    pose, tsl = rotate_about_root(mano, inv, pose, shape, tsl)
    pose, tsl = scramble_random(pose, tsl, draws["scram"], cfg["SCRAMBLER"])
    obj = c(data["objects"]["verts"][oid]) @ inv.transpose(1, 2)
    rots, tsl = refine(mano, net, pose, shape, tsl, obj, c(data["objects"]["valid"][oid]),
                       int(cfg["REFINER"].get("ITERS", 3)))
    _, joints = ref_mano.forward(mano, shape, rots=rots)
    joints = (joints + (tsl + cam_offset)[:, None]) @ v["roll"].transpose(1, 2)
    corners = (c(data["objects"]["corners"][oid]) @ inv.transpose(1, 2)
               + cam_offset[:, None]) @ v["roll"].transpose(1, 2)
    return {"joints": joints, "corners": corners}


def final_hand(mano: Dict, hand_pose, hand_shape, hand_tsl, cam_offset, cam_free):
    """The program's pose cache rows -> the final hand joints (B, 21, 3) in
    the camera frame, by the reference's FK."""
    _, j = ref_mano.forward(mano, hand_shape, pose=hand_pose)
    dt = j.dtype
    return (j + (hand_tsl.to(dt) + cam_offset.to(dt))[:, None]) @ cam_free.to(dt).transpose(1, 2)
