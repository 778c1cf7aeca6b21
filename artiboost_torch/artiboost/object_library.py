"""Object mesh library as dense padded tensors (counterpart of
``artiboost_tpu/artiboost/object_library.py``; reference
``anakin/artiboost/object_engine.py``). Only the deterministic synthetic
library (boxes and cylinders with procedural textures) exists until the
YCB assets are in the repository."""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.transform import center_vert_bbox


class ObjectLibrary(NamedTuple):
    names: tuple
    verts: torch.Tensor        # (n_obj, V_MAX, 3) canonical, padded
    vert_valid: torch.Tensor   # (n_obj, V_MAX)
    faces: torch.Tensor        # (n_obj, F_MAX, 3) int64, padded (index 0)
    face_valid: torch.Tensor   # (n_obj, F_MAX)
    colors: torch.Tensor       # (n_obj, V_MAX, 3)
    corners_can: torch.Tensor  # (n_obj, 8, 3)
    n_verts: torch.Tensor      # (n_obj,)
    uvs: Optional[torch.Tensor] = None       # (n_obj, V_MAX, 2)
    textures: Optional[torch.Tensor] = None  # (n_obj, T, T, 3)

    @property
    def n_obj(self) -> int:
        return len(self.names)


def _resize_tex(tex: np.ndarray, T: int) -> np.ndarray:
    if tex.shape[0] == T and tex.shape[1] == T:
        return tex.astype(np.float32)
    from PIL import Image

    im = Image.fromarray((np.clip(tex, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((T, T), Image.BILINEAR), np.float32) / 255.0


def _bbox_corners(verts: np.ndarray) -> np.ndarray:
    lo, hi = verts.min(0), verts.max(0)
    return np.array([
        [lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
        [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
        [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]],
    ], np.float32)


def _pack(meshes: List[dict], names: List[str], v_max: int, f_max: int,
          tex_size: int, device) -> ObjectLibrary:
    n = len(meshes)
    verts = np.zeros((n, v_max, 3), np.float32)
    vval = np.zeros((n, v_max), np.float32)
    faces = np.zeros((n, f_max, 3), np.int64)
    fval = np.zeros((n, f_max), np.float32)
    colors = np.full((n, v_max, 3), 0.6, np.float32)
    corners = np.zeros((n, 8, 3), np.float32)
    nv = np.zeros((n,), np.int64)
    uvs = np.zeros((n, v_max, 2), np.float32)
    texs = np.full((n, tex_size, tex_size, 3), 0.6, np.float32)
    for i, m in enumerate(meshes):
        mv, mf = m["verts"], m["faces"]
        if mv.shape[0] > v_max:
            mv = mv[:v_max]
            mf = mf[(mf < v_max).all(axis=1)]
        mf = mf[:f_max]
        V, F = mv.shape[0], mf.shape[0]
        verts[i, :V] = mv
        vval[i, :V] = 1.0
        faces[i, :F] = mf
        fval[i, :F] = 1.0
        colors[i, :V] = m["colors"][:V]
        corners[i] = m["corners"]
        nv[i] = V
        uvs[i, :V] = m["uv"][:V]
        texs[i] = _resize_tex(m["tex"], tex_size)
    t = lambda a: torch.as_tensor(a).to(device)
    return ObjectLibrary(
        names=tuple(names), verts=t(verts), vert_valid=t(vval), faces=t(faces),
        face_valid=t(fval), colors=t(colors), corners_can=t(corners), n_verts=t(nv),
        uvs=t(uvs), textures=t(texs))


def synthetic_object_library(query_obj: List[str], seed: int = 0, v_max: int = 512,
                             f_max: int = 1024, device=None) -> ObjectLibrary:
    """Deterministic procedural objects (even index: box gridded on each
    side; odd: closed cylinder), outward-wound, with per-object color and a
    checker/stripe/noise texture."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    meshes = []
    for i, _ in enumerate(query_obj):
        size = 0.05 + 0.03 * rng.rand(3)
        vs, fs, uv = [], [], []
        if i % 2 == 0:
            n_side = 8
            grid = np.linspace(-0.5, 0.5, n_side)
            for axis in range(3):
                for sgn in (-1.0, 1.0):
                    base = len(vs)
                    for a in grid:
                        for b in grid:
                            p = np.zeros(3)
                            p[axis] = 0.5 * sgn
                            p[(axis + 1) % 3] = a
                            p[(axis + 2) % 3] = b
                            vs.append(p)
                            uv.append([a + 0.5, b + 0.5])
                    for r in range(n_side - 1):
                        for c in range(n_side - 1):
                            p0 = base + r * n_side + c
                            fs.append([p0, p0 + 1, p0 + n_side])
                            fs.append([p0 + 1, p0 + n_side + 1, p0 + n_side])
            verts = np.asarray(vs, np.float32) * size * 2
        else:
            n_seg, n_h = 24, 10
            for hi in range(n_h):
                z = (hi / (n_h - 1) - 0.5) * size[2] * 2
                for si in range(n_seg):
                    a = 2 * np.pi * si / n_seg
                    vs.append([size[0] * np.cos(a), size[1] * np.sin(a), z])
                    uv.append([si / n_seg, hi / (n_h - 1)])
            for hi in range(n_h - 1):
                for si in range(n_seg):
                    p0 = hi * n_seg + si
                    p1 = hi * n_seg + (si + 1) % n_seg
                    fs.append([p0, p1, p0 + n_seg])
                    fs.append([p1, p1 + n_seg, p0 + n_seg])
            c_bot, c_top = len(vs), len(vs) + 1
            vs.append([0.0, 0.0, -size[2]])
            uv.append([0.5, 0.0])
            vs.append([0.0, 0.0, size[2]])
            uv.append([0.5, 1.0])
            top = (n_h - 1) * n_seg
            for si in range(n_seg):
                fs.append([c_bot, (si + 1) % n_seg, si])
                fs.append([c_top, top + si, top + (si + 1) % n_seg])
            verts = np.asarray(vs, np.float32)
        faces = np.asarray(fs, np.int32)
        uvs = np.asarray(uv, np.float32)
        verts = center_vert_bbox(verts)
        fv = verts[faces]
        normal = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        flip = (normal * fv.mean(1)).sum(-1) < 0
        faces[flip] = faces[flip][:, ::-1]
        base = rng.rand(3).astype(np.float32) * 0.6 + 0.2
        T = 128
        ty, tx = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        checker = (((tx // 16) + (ty // 16)) % 2).astype(np.float32)
        stripes = 0.5 + 0.5 * np.sin(2 * np.pi * tx / 32.0 + i)
        noise = rng.rand(T, T).astype(np.float32)
        mod = (0.75 + 0.35 * checker * 0.5 + 0.15 * stripes + 0.1 * noise)
        tex = np.clip(base[None, None] * mod[..., None], 0.0, 1.0)
        meshes.append({
            "verts": verts, "faces": faces,
            "colors": np.tile(base, (verts.shape[0], 1)),
            "uv": uvs, "tex": tex.astype(np.float32),
            "corners": _bbox_corners(verts),
        })
    return _pack(meshes, query_obj, v_max, f_max, 128, device)


def get_object_library(query_obj: List[str], device=None) -> ObjectLibrary:
    device = resolve_device(device)
    logger.warning("YCB object assets are not ported yet; using the synthetic "
                   "object library")
    return synthetic_object_library(query_obj, device=device)
