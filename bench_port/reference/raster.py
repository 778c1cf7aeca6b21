"""The plain reference rasterizer: for every pixel centre (x + 0.5,
y + 0.5) and every face, the face's barycentric coordinates in screen
space; a face covers the pixel where all three are at least -1e-6; of
the covering faces the one with the largest interpolated 1/z is seen,
and the depth is the inverse of that. Faces that are invalid, degenerate
(screen area under 1e-9) or, with culling, wound clockwise on the screen
(signed area >= 0 under the y-down pixel convention) are skipped.

Nothing here is tiled, binned or packed: pixels and faces are compared
all against all, a block of pixels at a time. ``dtype`` bfloat16 is the
control that a lower precision than the program's float32 must fail."""
from __future__ import annotations

from typing import Optional

import torch


def raster_depth(verts_screen: torch.Tensor, faces: torch.Tensor,
                 face_valid: Optional[torch.Tensor], height: int, width: int,
                 cull_backfaces: bool, dtype=torch.float32, block: int = 1024) -> torch.Tensor:
    """verts_screen (B, V, 3) as (x pixels, y pixels, z), faces (B, F, 3) or
    (F, 3), face_valid (B, F) or None -> depth (B, H, W), 0 = background."""
    return raster(verts_screen, faces, face_valid, height, width, cull_backfaces, None,
                  dtype, block)[0]


def raster(verts_screen: torch.Tensor, faces: torch.Tensor, face_valid: Optional[torch.Tensor],
           height: int, width: int, cull_backfaces: bool, attrs: Optional[torch.Tensor] = None,
           dtype=torch.float32, block: int = 1024):
    """-> (depth (B, H, W), and with ``attrs`` (B, V, A) the seen face's
    attributes at each pixel, interpolated perspective-correctly (their
    barycentric blend over z, over the blend of 1/z), (B, H, W, A))."""
    B = verts_screen.shape[0]
    if faces.dim() == 2:
        faces = faces[None].expand(B, -1, -1)
    faces = faces.long()
    F_ = faces.shape[1]
    idx = faces.reshape(B, F_ * 3, 1)
    v = torch.gather(verts_screen.to(dtype), 1, idx.expand(B, F_ * 3, 3)).reshape(B, F_, 3, 3)
    x, y = v[..., 0], v[..., 1]
    inv_z = 1.0 / torch.clamp_min(v[..., 2], 1e-6)
    fa = None
    if attrs is not None:
        A = attrs.shape[-1]
        fa = torch.gather(attrs.to(dtype), 1, idx.expand(B, F_ * 3, A)).reshape(B, F_, 3, A)
        fa = fa * inv_z[..., None]
    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0]))
    ok = area.abs() > 1e-9
    if face_valid is not None:
        ok = ok & (face_valid > 0)
    if cull_backfaces:
        ok = ok & (area < 0)
    safe = torch.where(ok, area, torch.ones_like(area))
    dev = verts_screen.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    px = (xs.reshape(-1).to(dtype) + 0.5)
    py = (ys.reshape(-1).to(dtype) + 0.5)
    depth = torch.zeros((B, height * width), dtype=torch.float32, device=dev)
    out = None if fa is None else torch.zeros((B, height * width, fa.shape[-1]),
                                              dtype=torch.float32, device=dev)
    for s in range(0, px.numel(), block):
        qx, qy = px[s:s + block][None, :, None], py[s:s + block][None, :, None]
        lam = []
        for k in range(3):  # barycentric weight of vertex k: the sub-triangle opposite it
            a, b = (k + 1) % 3, (k + 2) % 3
            sub = ((x[..., b][:, None] - x[..., a][:, None]) * (qy - y[..., a][:, None])
                   - (y[..., b][:, None] - y[..., a][:, None]) * (qx - x[..., a][:, None]))
            lam.append(sub / safe[:, None])
        lam = torch.stack(lam, -1)  # (B, P, F, 3)
        inside = (lam >= -1e-6).all(-1) & ok[:, None]
        iz = (lam * inv_z[:, None]).sum(-1)
        iz = torch.where(inside, iz, torch.full_like(iz, -1.0))
        best, win = iz.max(dim=2)
        hit = best > 0
        depth[:, s:s + block] = torch.where(hit, 1.0 / torch.clamp_min(best.float(), 1e-9), 0.0)
        if fa is not None:
            lw = torch.gather(lam, 2, win[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
            fw = torch.gather(fa, 1, win.reshape(B, -1, 1, 1).expand(-1, -1, 3, fa.shape[-1]))
            a = (lw[..., None] * fw).sum(2) / torch.clamp_min(best, 1e-9)[..., None]
            out[:, s:s + block] = torch.where(hit[..., None], a.float(), 0.0)
    depth = depth.reshape(B, height, width)
    return depth, None if out is None else out.reshape(B, height, width, -1)
