"""Triangle-raster geometry on torch tensors (counterpart of
``artiboost_tpu/ops/rasterizer.py``): projection, per-face edge/depth/
attribute planes, area-weighted vertex normals, and the plain raster
(``rasterize_batch``) that ``chip_parity`` holds the kernels against.

Conventions: CV camera (x right, y down, z forward > 0); pixel centers
at integer + 0.5; faces carry a validity mask; the inside test is
winding-agnostic and the z-test resolves closed meshes."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-9
_BIG = 1e30


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

    # the next and the previous vertex of each: x[..., [1, 2, 0]], x[..., [2, 0, 1]]
    x1, y1 = x.roll(-1, dims=-1), y.roll(-1, dims=-1)
    x2, y2 = x.roll(1, dims=-1), y.roll(1, dims=-1)
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


def rasterize_batch(verts_screen: torch.Tensor, vert_attrs: torch.Tensor, faces: torch.Tensor,
                    face_valid: Optional[torch.Tensor], height: int, width: int,
                    face_chunk: int = 512, row_chunk: int = 16, cull_backfaces: bool = False):
    """The plain raster the kernels are held against (JAX ``rasterize`` and
    ``rasterize_batch``, :112-217): per pixel, the closest covering face by
    interpolated 1/z, its attrs interpolated perspective-correct. Faces are
    scanned in chunks of ``face_chunk`` (the last one clamped to end at F,
    as ``dynamic_slice`` does); the first best face of a chunk wins within
    it and a later chunk wins only on a strictly larger 1/z. Rows go
    ``row_chunk`` at a time to bound memory.
    -> (attrs (B, H, W, A), depth (B, H, W)); depth 0 = background."""
    sf = build_screen_faces(verts_screen, vert_attrs, faces, face_valid, cull_backfaces)
    B, F = sf.valid.shape
    A, dev = vert_attrs.shape[-1], verts_screen.device
    chunk = min(face_chunk, F)
    starts = [min(s, F - chunk) for s in range(0, F, chunk)]
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    attrs = torch.zeros((B, height, width, A), dtype=torch.float32, device=dev)
    depth = torch.zeros((B, height, width), dtype=torch.float32, device=dev)
    for y0 in range(0, height, row_chunk):
        ys = torch.arange(y0, min(y0 + row_chunk, height), dtype=torch.float32, device=dev) + 0.5
        py, px = (t.reshape(-1) for t in torch.meshgrid(ys, xs, indexing="ij"))
        best_w = torch.full((B, px.numel()), -_BIG, device=dev)
        best_attr = torch.zeros((B, px.numel(), A), device=dev)
        for s in starts:
            ea, eb, ec, izv, aoz, val = (a[:, s:s + chunk] for a in (
                sf.edge_a, sf.edge_b, sf.edge_c, sf.inv_z, sf.attr_over_z, sf.valid))
            lam = (px[None, :, None, None] * ea[:, None] + py[None, :, None, None] * eb[:, None]
                   + ec[:, None])  # (B, P, C, 3)
            inside = torch.all(lam >= -1e-6, dim=-1) & (val[:, None, :] > 0)
            w = torch.where(inside, torch.einsum("bpck,bck->bpc", lam, izv), -_BIG)
            best_c = torch.argmax(w, dim=2)  # the first of equal maxima
            w_c = torch.gather(w, 2, best_c[..., None])[..., 0]
            lam_c = torch.gather(lam, 2, best_c[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
            aoz_c = torch.gather(aoz, 1, best_c[..., None, None].expand(-1, -1, 3, A))
            attr_c = torch.einsum("bpk,bpka->bpa", lam_c, aoz_c)
            take = w_c > best_w
            best_attr = torch.where(take[..., None], attr_c, best_attr)
            best_w = torch.maximum(best_w, w_c)
        hit = best_w > 0
        d = torch.where(hit, 1.0 / torch.clamp_min(best_w, _EPS), 0.0)
        rows = slice(y0, y0 + ys.numel())
        depth[:, rows] = d.reshape(B, -1, width)
        attrs[:, rows] = torch.where(hit[..., None], best_attr * d[..., None],
                                     0.0).reshape(B, -1, width, A)
    return attrs, depth


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


def shade_vertices(verts: torch.Tensor, normals: torch.Tensor, base_color: torch.Tensor,
                   ambient: float, light_pos: torch.Tensor, light_intensity: torch.Tensor,
                   light_color: torch.Tensor) -> torch.Tensor:
    """Lambertian per-vertex (Gouraud) shading, batched: verts, normals,
    base_color (B, V, 3), light_pos (L, 3), light_intensity (B, L),
    light_color (L, 3) -> clip(base_color * (ambient + sum_l two-sided
    lambert_l * intensity_l / dist2_l * color_l), 0, 1) (pyrender's
    ambient 0.8 plus random point lights, reference renderer.py:78,104)."""
    to_light = light_pos[None, :, None] - verts[:, None]  # (B, L, V, 3)
    dist2 = torch.sum(to_light * to_light, dim=-1)
    dirn = to_light / torch.clamp_min(torch.sqrt(dist2)[..., None], 1e-8)
    lam = torch.abs(torch.einsum("blvk,bvk->blv", dirn, normals))
    contrib = light_intensity[..., None] * lam / torch.clamp_min(dist2, 1e-4)
    shade = ambient * torch.ones_like(base_color) + torch.einsum("blv,lc->bvc", contrib,
                                                                 light_color)
    return torch.clamp(base_color * shade, 0.0, 1.0)


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
