"""Triangle-raster geometry on torch tensors (counterpart of
``artiboost_tpu/ops/rasterizer.py``): projection, per-face edge/depth/
attribute planes, and area-weighted vertex normals.

Conventions: CV camera (x right, y down, z forward > 0); pixel centers
at integer + 0.5; faces carry a validity mask; the inside test is
winding-agnostic and the z-test resolves closed meshes."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-9


class ScreenFace(NamedTuple):
    """Per-face raster quantities for a batch of images."""

    edge_a: torch.Tensor       # (B, F, 3) e_k = a_k x + b_k y + c_k = lambda_k
    edge_b: torch.Tensor       # (B, F, 3)
    edge_c: torch.Tensor       # (B, F, 3)
    inv_z: torch.Tensor        # (B, F, 3) per-vertex 1/z
    attr_over_z: torch.Tensor  # (B, F, 3, A) per-vertex attr/z
    valid: torch.Tensor        # (B, F) 1 = rasterize this face
    bbox: torch.Tensor         # (B, F, 4) xmin, ymin, xmax, ymax in pixels


def project_verts(verts_cam: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) camera space + (B, 3, 3) intrinsics -> (B, V, 3) (x_pix, y_pix, z)."""
    z = torch.clamp_min(verts_cam[..., 2], 1e-6)
    fx, fy = intr[:, 0, 0, None], intr[:, 1, 1, None]
    cx, cy = intr[:, 0, 2, None], intr[:, 1, 2, None]
    x = verts_cam[..., 0] / z * fx + cx
    y = verts_cam[..., 1] / z * fy + cy
    return torch.stack([x, y, z], dim=-1)


def _gather_faces(a: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """a (B, V, C), faces (B, F, 3) -> (B, F, 3, C)."""
    B, F = faces.shape[:2]
    idx = faces.reshape(B, F * 3, 1).expand(B, F * 3, a.shape[-1])
    return torch.gather(a, 1, idx).reshape(B, F, 3, a.shape[-1])


def build_screen_faces(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                       faces: torch.Tensor, face_valid: Optional[torch.Tensor] = None,
                       cull_backfaces: bool = False) -> ScreenFace:
    """verts_screen (B, V, 3), vert_attrs (B, V, A), faces (B, F, 3) or
    (F, 3), face_valid (B, F) -> ScreenFace. Edge k is opposite vertex k;
    planes are scaled by 1/area so e_k is the barycentric lambda_k."""
    B = verts_screen.shape[0]
    if faces.dim() == 2:
        faces = faces[None].expand(B, -1, -1)
    faces = faces.long()
    v = _gather_faces(verts_screen, faces)
    a = _gather_faces(vert_attrs, faces)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]

    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0]))
    flip = torch.where(area < 0, -1.0, 1.0)
    abs_area = torch.abs(area)
    inv_area = flip / torch.where(abs_area < _EPS, torch.full_like(abs_area, _EPS), abs_area)

    k1, k2 = [1, 2, 0], [2, 0, 1]
    x1, y1 = x[..., k1], y[..., k1]
    x2, y2 = x[..., k2], y[..., k2]
    ea = -(y2 - y1) * inv_area[..., None]
    eb = (x2 - x1) * inv_area[..., None]
    ec = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv_area[..., None]

    valid = (torch.ones_like(area) if face_valid is None else face_valid.float())
    valid = valid * (abs_area > _EPS).float()
    if cull_backfaces:
        # outward-wound faces seen from the front project to NEGATIVE
        # signed area under the y-down pixel convention
        valid = valid * (area < 0).float()

    inv_z = 1.0 / torch.clamp_min(z, 1e-6)
    bbox = torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], dim=-1)
    return ScreenFace(edge_a=ea, edge_b=eb, edge_c=ec, inv_z=inv_z,
                      attr_over_z=a * inv_z[..., None], valid=valid, bbox=bbox)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3), (B, F, 3) -> (B, V, 3) area-weighted normals (scatter-add)."""
    v = _gather_faces(verts, faces.long())
    fn = torch.linalg.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0], dim=-1)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.scatter_add_(1, faces[..., k].long()[..., None].expand_as(fn), fn)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-8)


def build_face_incidence(faces: np.ndarray, n_verts: int, min_degree: int = 0) -> np.ndarray:
    """Host precompute: (F, 3) faces -> (V, D) incidence lists padded with
    F (an implicit zero face normal); degenerate padded faces skipped."""
    F = faces.shape[0]
    lists: list = [[] for _ in range(n_verts)]
    for fi, f in enumerate(np.asarray(faces)):
        if f[0] == f[1] == f[2]:
            continue
        for vtx in f:
            lists[int(vtx)].append(fi)
    D = max(max((len(l) for l in lists), default=1), min_degree, 1)
    inc = np.full((n_verts, D), F, np.int64)
    for vtx, l in enumerate(lists):
        inc[vtx, :len(l)] = l
    return inc


def vertex_normals_indexed(verts: torch.Tensor, faces: torch.Tensor,
                           incidence: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals as D gathers over a precomputed
    incidence table (B, V, D) whose entries == F select a zero row."""
    v = _gather_faces(verts, faces.long())
    fn = torch.linalg.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0], dim=-1)
    fn_pad = torch.cat([fn, torch.zeros_like(fn[:, :1])], dim=1)
    B, V, D = incidence.shape
    idx = incidence.reshape(B, V * D, 1).expand(B, V * D, 3)
    vn = torch.gather(fn_pad, 1, idx).reshape(B, V, D, 3).sum(dim=2)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-8)
