"""Rotation / projection / crop math on torch tensors: the part of
``artiboost_tpu/utils/transform.py`` that the synthesis-and-mining pass
calls (reference ``anakin/utils/transform.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from artiboost_torch.utils.misc import device_constant


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues, with
    the first-order form below 1e-6 rad)."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = sq < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    theta = torch.where(small, torch.zeros_like(theta), theta)
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    k = skew(axis)
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    eye = _eye_like(k)
    rot = eye + st * k + (1.0 - ct) * (k @ k)
    rot_small = eye + skew(aa)
    return torch.where(small[..., None], rot_small, rot)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz
    (branch-free Shepperd: best-conditioned of four candidates)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]

    def _abs_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    qw = 0.5 * _abs_sqrt(1.0 + m00 + m11 + m22)
    qx = 0.5 * _abs_sqrt(1.0 + m00 - m11 - m22)
    qy = 0.5 * _abs_sqrt(1.0 - m00 + m11 - m22)
    qz = 0.5 * _abs_sqrt(1.0 - m00 - m11 + m22)

    def d(q):
        return 4 * torch.clamp_min(q, 1e-8)

    c0 = torch.stack([qw, (m21 - m12) / d(qw), (m02 - m20) / d(qw), (m10 - m01) / d(qw)], -1)
    c1 = torch.stack([(m21 - m12) / d(qx), qx, (m01 + m10) / d(qx), (m02 + m20) / d(qx)], -1)
    c2 = torch.stack([(m02 - m20) / d(qy), (m01 + m10) / d(qy), qy, (m12 + m21) / d(qy)], -1)
    c3 = torch.stack([(m10 - m01) / d(qz), (m02 + m20) / d(qz), (m12 + m21) / d(qz), qz], -1)

    best = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-8)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> axis-angle (..., 3)."""
    q = quat / torch.clamp_min(torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    axis = xyz / torch.clamp_min(sin_half, 1e-8)
    small = sin_half < 1e-6
    aa_small = 2.0 * xyz / torch.clamp_min(torch.abs(w[..., None]), 1e-8) * torch.sign(w[..., None])
    return torch.where(small, aa_small, axis * angle)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz, normalised (eps 1e-8) -> rotation matrix
    (..., 3, 3)."""
    q = quat / torch.clamp_min(torch.linalg.norm(quat, dim=-1, keepdim=True), 1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4) wxyz, xyz = aa / 2 below
    1e-6 rad."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp_min(theta, 1e-8)
    half = theta / 2.0
    xyz = torch.where(theta < 1e-6, aa / 2.0, axis * torch.sin(half))
    return torch.cat([torch.cos(half), xyz], dim=-1)


def rotmat_to_aa(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_aa(rotmat_to_quat(rot))


def rotmat_proj(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3): the nearest rotation u @ vt by SVD,
    with u's last column negated where det(u @ vt) < 0 (manotorch
    ``batch_rotprojs``). The signs of u and vt are the solver's own; their
    product is not."""
    u, _, vt = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u = torch.cat([u[..., :2], u[..., 2:] * sign[..., None, None]], dim=-1)
    return u @ vt


def rot6d_to_rotmat(d6: torch.Tensor) -> torch.Tensor:
    """Ortho-6D (..., 6) -> rotation matrix via Gram-Schmidt; columns are
    (x, y, z) with x = normalize(a), z = normalize(x x b), y = z x x."""
    a, b = d6[..., 0:3], d6[..., 3:6]
    x = a / torch.clamp_min(torch.linalg.norm(a, dim=-1, keepdim=True), 1e-8)
    z = torch.linalg.cross(x, b, dim=-1)
    z = z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def homogeneous(rt: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) by appending [0, 0, 0, 1]."""
    bottom = torch.zeros(rt.shape[:-2] + (1, 4), dtype=rt.dtype, device=rt.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([rt, bottom], dim=-2)


def rt_to_transf(rot: torch.Tensor, tsl: torch.Tensor) -> torch.Tensor:
    """rot (..., 3, 3) + tsl (..., 3) -> (..., 4, 4)."""
    return homogeneous(torch.cat([rot, tsl[..., :, None]], dim=-1))


def align_vector_to_z(vec: torch.Tensor) -> torch.Tensor:
    """Rotation R with R @ z_hat = vec (reference
    ``ViewEngine.caculate_align_mat``; antiparallel -> pi about x)."""
    v = vec / torch.clamp_min(torch.linalg.norm(vec, dim=-1, keepdim=True), 1e-8)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    c = torch.sum(z * v, dim=-1)
    k = skew(torch.linalg.cross(z, v, dim=-1))
    eye = _eye_like(k)
    denom = torch.clamp_min(1.0 + c, 1e-6)[..., None, None]
    rot = eye + k + (k @ k) / denom
    flip = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                        dtype=vec.dtype, device=vec.device).expand(k.shape)
    return torch.where((c < -1.0 + 1e-6)[..., None, None], flip, rot)


def batch_uvd2xyz(uvd: torch.Tensor, root_joint: torch.Tensor, intr: torch.Tensor,
                  inp_res: Sequence[int] = (256, 256), depth_range: float = 0.4
                  ) -> torch.Tensor:
    """Normalized uvd (B, N, 3) -> camera-space xyz with the GT root depth
    (reference transform.py:473-546; unit reference bone length)."""
    res = device_constant(tuple(inp_res), uvd.device, uvd.dtype)
    uv = uvd[..., :2] * res
    d = (uvd[..., 2] - 0.5) * depth_range
    z = d + root_joint[:, 2:3]
    f = torch.stack([intr[:, 0, 0], intr[:, 1, 1]], dim=-1)[:, None, :]
    c = torch.stack([intr[:, 0, 2], intr[:, 1, 2]], dim=-1)[:, None, :]
    xy = (uv - c) / f * z[..., None]
    return torch.cat([xy, z[..., None]], dim=-1)


def batch_persp_proj2d(verts: torch.Tensor, camintr: torch.Tensor) -> torch.Tensor:
    """Project (B, N, 3) points with (B, 3, 3) intrinsics -> (B, N, 2) pixels."""
    hom = torch.einsum("bij,bnj->bni", camintr, verts)
    return hom[..., :2] / torch.clamp_min(hom[..., 2:], 1e-8)


def get_affine_trans_no_rot(center: torch.Tensor, scale: torch.Tensor, res) -> torch.Tensor:
    """2D affine mapping a square crop (center (..., 2), scale (...)) to an
    ``res`` image (reference ``get_affine_trans_no_rot``, transform.py:461)."""
    res0, res1 = float(res[0]), float(res[1])
    ratio = res0 / res1
    a00 = res0 / scale
    a11 = res1 / scale * ratio
    a02 = res0 * (-center[..., 0] / scale + 0.5)
    a12 = res1 * (-center[..., 1] / scale * ratio + 0.5)
    zero, one = torch.zeros_like(a00), torch.ones_like(a00)
    return torch.stack([
        torch.stack([a00, zero, a02], -1),
        torch.stack([zero, a11, a12], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def center_vert_bbox(vertices: np.ndarray):
    """Center mesh vertices on their bbox center (host numpy)."""
    return vertices - (vertices.min(0) + vertices.max(0)) / 2


# MANO FK emits [wrist, 4 x index, 4 x middle, 4 x pinky, 4 x ring, 4 x thumb]
# and the tips; this permutation gives the conventional 21-keypoint order,
# and the HO3D Codalab dump takes its inverse (``submit/epoch_pass.py``)
MANO_TO_OPENPOSE_ORDER = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
