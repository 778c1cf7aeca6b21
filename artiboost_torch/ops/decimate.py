"""Host-side mesh decimation (vertex clustering) for render LOD, a copy
of ``artiboost_tpu/ops/decimate.py`` (pure numpy) so both packages
render the same decimated geometry.

The reference draws full-resolution meshes through OpenGL
(``anakin/utils/renderer.py:52-55``) whose detail is sub-pixel once the
224x224 render-at-crop camera is applied; the rasterizer's cost scales
with the face count, so render-only geometry is decimated.

Design: uniform-grid vertex clustering with a NORMAL half-axis split —
vertices only merge when they share a grid cell AND their normals point
into the same half-axis bucket, which stops thin structures (the hand's
palm/back surfaces, mug walls) from collapsing into sheets. Two
variants:

  * ``decimate_mesh``      — static meshes (objects): new vertices are
    cluster means, colors averaged;
  * ``decimate_topology``  — dynamic meshes (the MANO hand, skinned per
    frame): representatives are ORIGINAL vertex indices so the reduced
    mesh is a pure gather from the FK output at render time.

All of it runs once at asset-load time on the host (numpy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (V, 3), host numpy."""
    fv = verts[faces]  # (F, 3, 3)
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def _cluster_ids(verts: np.ndarray, faces: np.ndarray, h: float) -> np.ndarray:
    """(V,) cluster id per vertex on a uniform grid of CELL SIZE ``h``
    (metric units) x 6 normal half-axes. A continuous cell size — rather
    than an integer per-axis resolution — makes the achievable face
    counts near-continuous in h, so the budget search can actually land
    near any target (an integer g^3 grid jumps e.g. 20 -> 180 faces
    between consecutive g on the MANO hand)."""
    lo = verts.min(0)
    extent = np.maximum(verts.max(0) - lo, 1e-9)
    n_cells = np.maximum(np.ceil(extent / max(h, 1e-9)), 1.0).astype(np.int64)
    cell = np.minimum((verts - lo) / max(h, 1e-9), n_cells - 1e-4).astype(np.int64)
    vn = _vertex_normals_np(verts, faces)
    axis = np.abs(vn).argmax(1)
    bucket = axis * 2 + (np.take_along_axis(vn, axis[:, None], 1)[:, 0] > 0)
    return ((cell[:, 0] * n_cells[1] + cell[:, 1]) * n_cells[2]
            + cell[:, 2]) * 6 + bucket


def _collapse(verts: np.ndarray, faces: np.ndarray, cid: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (unique cluster inverse map (V,), kept faces (F', 3) in cluster
    ids, n_clusters). Faces with <3 distinct clusters or duplicating an
    earlier face (same vertex set) are dropped; winding is preserved."""
    _, inv = np.unique(cid, return_inverse=True)
    nf = inv[faces]
    keep = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
    nf = nf[keep]
    # dedupe coincident faces regardless of winding/rotation; keep first
    key = np.sort(nf, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    nf = nf[np.sort(first)]
    return inv, nf, int(inv.max()) + 1 if inv.size else 0


def _search_grid(verts: np.ndarray, faces: np.ndarray, target_faces: int,
                 iters: int = 28) -> float:
    """Largest cell size h whose decimation keeps <= target faces
    (face count shrinks as h grows; float binary search on h)."""
    extent = float(np.max(verts.max(0) - verts.min(0)))
    lo, hi = extent / 512.0, extent  # lo ~ full-res, hi ~ one cell/axis
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        _, nf, _ = _collapse(verts, faces, _cluster_ids(verts, faces, mid))
        if nf.shape[0] <= target_faces:
            hi = mid  # small enough face count: try finer cells
        else:
            lo = mid
    return hi


def decimate_mesh(
    verts: np.ndarray,           # (V, 3)
    faces: np.ndarray,           # (F, 3) int
    target_faces: int,
    colors: Optional[np.ndarray] = None,  # (V, K) any per-vertex attrs
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """-> (verts' (V', 3) cluster means, faces' (F'<=target, 3), colors'
    (V', K) cluster-mean attributes)."""
    if faces.shape[0] <= target_faces:
        return verts, faces, colors
    g = _search_grid(verts, faces, target_faces)
    inv, nf, n = _collapse(verts, faces, _cluster_ids(verts, faces, g))
    cnt = np.bincount(inv, minlength=n).astype(np.float32)[:, None]
    nv = np.zeros((n, 3), np.float32)
    np.add.at(nv, inv, verts.astype(np.float32))
    nv /= np.maximum(cnt, 1.0)
    nc = None
    if colors is not None:
        nc = np.zeros((n, colors.shape[1]), np.float32)
        np.add.at(nc, inv, colors.astype(np.float32))
        nc /= np.maximum(cnt, 1.0)
    return nv, nf.astype(np.int32), nc


def decimate_topology(
    verts: np.ndarray,           # (V, 3) template/rest positions
    faces: np.ndarray,           # (F, 3)
    target_faces: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rep (V',) indices into the ORIGINAL verts, faces' (F', 3)
    indexing the compacted rep space). For skinned meshes: at render time
    ``verts_lod = skinned_verts[:, rep]`` is an exact surface sample."""
    if faces.shape[0] <= target_faces:
        return np.arange(verts.shape[0], dtype=np.int32), faces.astype(np.int32)
    g = _search_grid(verts, faces, target_faces)
    inv, nf, n = _collapse(verts, faces, _cluster_ids(verts, faces, g))
    # representative = original vertex nearest its cluster's mean
    cnt = np.bincount(inv, minlength=n).astype(np.float32)[:, None]
    mean = np.zeros((n, 3), np.float32)
    np.add.at(mean, inv, verts.astype(np.float32))
    mean /= np.maximum(cnt, 1.0)
    d = np.linalg.norm(verts - mean[inv], axis=1)
    rep = np.full((n,), -1, np.int64)
    best = np.full((n,), np.inf)
    order = np.argsort(d)  # first hit per cluster is its nearest vertex
    for vi in order:
        c = inv[vi]
        if d[vi] < best[c]:
            best[c] = d[vi]
            rep[c] = vi
    return rep.astype(np.int32), nf.astype(np.int32)
