"""The work a triangle raster of one call needs, counted from its inputs
alone, whatever implements it: the vertices and attributes of the faces
that can be seen (valid, not degenerate, and front-facing where back
faces are culled) read once with their three indices, 16 bytes written a
pixel (the packed texture coordinate, shade and page, the winning face
and the depth), and 25 operations for each pair of a pixel centre and a
face whose screen bounding box holds it (three edge functions, the
inside test, the 1/z interpolation and the depth test). Tables a kernel
builds for itself (face ranges, tiles, padding) are not counted."""
from __future__ import annotations

from typing import Dict, Optional

import torch

BYTES_PER_PIXEL = 16
OPS_PER_PAIR = 25


def raster_work(verts_screen: torch.Tensor, vert_attrs: torch.Tensor, faces: torch.Tensor,
                face_valid: Optional[torch.Tensor], height: int, width: int,
                cull_backfaces: bool) -> Dict[str, float]:
    """-> {"bytes", "ops", "pairs", "faces"} of one call."""
    B = verts_screen.shape[0]
    if faces.dim() == 2:
        faces = faces[None].expand(B, -1, -1)
    faces = faces.long()
    F_ = faces.shape[1]
    v = torch.gather(verts_screen.float(), 1,
                     faces.reshape(B, F_ * 3, 1).expand(B, F_ * 3, 3)).reshape(B, F_, 3, 3)
    x, y = v[..., 0], v[..., 1]
    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0]))
    ok = area.abs() > 1e-9
    if face_valid is not None:
        ok = ok & (face_valid > 0)
    if cull_backfaces:
        ok = ok & (area < 0)
    # pixel centres c + 0.5 inside [min, max]: c from ceil(min - 0.5) to floor(max - 0.5)
    x0 = torch.clamp(torch.ceil(x.amin(-1) - 0.5), min=0)
    x1 = torch.clamp(torch.floor(x.amax(-1) - 0.5), max=width - 1)
    y0 = torch.clamp(torch.ceil(y.amin(-1) - 0.5), min=0)
    y1 = torch.clamp(torch.floor(y.amax(-1) - 0.5), max=height - 1)
    nx = torch.clamp(x1 - x0 + 1, min=0)
    ny = torch.clamp(y1 - y0 + 1, min=0)
    pairs = float(torch.where(ok, nx * ny, torch.zeros_like(nx)).double().sum())
    n_faces = float(ok.sum())
    used = torch.zeros((B, verts_screen.shape[1]), dtype=torch.bool, device=verts_screen.device)
    rows = torch.arange(B, device=faces.device)[:, None, None].expand(B, F_, 3)
    used[rows[ok].reshape(-1), faces[ok].reshape(-1)] = True
    n_verts = float(used.sum())
    per_vert = 4 * (3 + vert_attrs.shape[-1])
    read = n_verts * per_vert + n_faces * 12
    written = B * height * width * BYTES_PER_PIXEL
    return {"bytes": read + written, "ops": pairs * OPS_PER_PAIR, "pairs": pairs, "faces": n_faces}
