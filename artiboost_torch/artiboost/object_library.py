"""Object mesh library as dense padded tensors (counterpart of
``artiboost_tpu/artiboost/object_library.py``; reference
``anakin/artiboost/object_engine.py``): the wavefront-OBJ reader with its
texture baking, the YCB loader (HO3D frame flip, bbox centring, stride
decimation above ``max_verts``, textures resized into ``_pack``'s atlas),
the deterministic synthetic library (boxes and cylinders with procedural
textures) and ``get_object_library``, which loads the YCB meshes where they
are on disk and falls back to the synthetic library."""
from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.transform import center_vert_bbox

# HO3D's YCB models live in an OpenGL-flipped frame (object_engine.py:35-41)
_HO3D_CAM_EXTR = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], dtype=np.float32)


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


def _find_texture(obj_path: str, mtllib: Optional[str]) -> Optional[str]:
    """The texture of an OBJ: the MTL's ``map_Kd``, else a sibling
    ``texture_map`` / ``texture`` PNG or JPEG."""
    d = os.path.dirname(obj_path)
    if mtllib:
        mtl_path = os.path.join(d, mtllib)
        if os.path.isfile(mtl_path):
            with open(mtl_path) as f:
                for line in f:
                    if line.strip().startswith("map_Kd"):
                        cand = os.path.join(d, line.split()[-1])
                        if os.path.isfile(cand):
                            return cand
    for name in ("texture_map.png", "texture.png", "texture_map.jpg", "texture.jpg"):
        cand = os.path.join(d, name)
        if os.path.isfile(cand):
            return cand
    return None


def load_obj_file(path: str, with_uv: bool = False):
    """Wavefront OBJ -> (verts (V, 3), faces (F, 3), colors or None), or
    with ``with_uv`` (verts, faces, colors, uv (V, 2) or None, texture or
    None). Polygons are fan-triangulated. Colours are the appended vertex
    colours when present, else the texture baked at each vertex's first UV
    (0.6 where a vertex has none)."""
    verts, faces, colors, uvs = [], [], [], []
    v_uv, mtllib = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith("mtllib "):
                mtllib = line.split()[-1]
            elif line.startswith("f "):
                idx = []
                for c in line.split()[1:]:
                    sub = c.split("/")
                    vi = int(sub[0]) - 1
                    idx.append(vi)
                    if len(sub) >= 2 and sub[1]:
                        v_uv.setdefault(vi, int(sub[1]) - 1)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    colors = np.asarray(colors, np.float32) if colors else None
    tex = uv_arr = None
    if uvs and v_uv:
        tex_path = _find_texture(path, mtllib)
        if tex_path:
            from PIL import Image

            with Image.open(tex_path) as im:
                tex = np.asarray(im.convert("RGB"), np.float32) / 255.0
            H, W = tex.shape[:2]
            uv_arr = np.zeros((len(verts), 2), np.float32)
            baked = np.full((len(verts), 3), 0.6, np.float32)
            for vi, ti in v_uv.items():
                if vi < len(verts) and ti < len(uvs):
                    u, w = uvs[ti]
                    uv_arr[vi] = (u, w)
                    baked[vi] = tex[min(int((1.0 - w) * (H - 1)), H - 1),
                                    min(int(u * (W - 1)), W - 1)]
            if colors is None:
                colors = baked
    if with_uv:
        return verts, faces, colors, uv_arr, tex
    return verts, faces, colors


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


def _pack(meshes: List[dict], names: List[str], v_max: Optional[int] = None,
          f_max: Optional[int] = None, tex_size: int = 256, device=None) -> ObjectLibrary:
    """Meshes -> padded tensors. ``uvs`` and ``textures`` are None unless
    some mesh has a texture; then an untextured mesh gets a constant
    texture at its mean albedo."""
    n = len(meshes)
    v_max = v_max or max(m["verts"].shape[0] for m in meshes)
    f_max = f_max or max(m["faces"].shape[0] for m in meshes)
    verts = np.zeros((n, v_max, 3), np.float32)
    vval = np.zeros((n, v_max), np.float32)
    faces = np.zeros((n, f_max, 3), np.int64)
    fval = np.zeros((n, f_max), np.float32)
    colors = np.full((n, v_max, 3), 0.6, np.float32)
    corners = np.zeros((n, 8, 3), np.float32)
    nv = np.zeros((n,), np.int64)
    any_tex = any(m.get("tex") is not None for m in meshes)
    uvs = np.zeros((n, v_max, 2), np.float32) if any_tex else None
    texs = np.full((n, tex_size, tex_size, 3), 0.6, np.float32) if any_tex else None
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
        if m.get("colors") is not None:
            colors[i, :V] = m["colors"][:V]
        corners[i] = m["corners"]
        nv[i] = V
        if any_tex:
            if m.get("uv") is not None:
                uvs[i, :V] = m["uv"][:V]
            if m.get("tex") is not None:
                texs[i] = _resize_tex(m["tex"], tex_size)
            elif m.get("colors") is not None:
                texs[i] = m["colors"][:V].mean(0)
    t = lambda a: None if a is None else torch.as_tensor(a).to(device)  # noqa: E731
    return ObjectLibrary(
        names=tuple(names), verts=t(verts), vert_valid=t(vval), faces=t(faces),
        face_valid=t(fval), colors=t(colors), corners_can=t(corners), n_verts=t(nv),
        uvs=t(uvs), textures=t(texs))


def load_object_library(query_obj: List[str], obj_root: str = "./data/YCB_models_process",
                        dataset_type: str = "HO3D", mesh_name: str = "ds_textured.obj",
                        max_verts: int = 2048, device=None) -> ObjectLibrary:
    """Real YCB meshes, canonical: HO3D's frame flip, centred on their
    bbox, stride-decimated to ``max_verts`` vertices (faces remapped to the
    nearest kept vertex at or after theirs, degenerate ones dropped)."""
    device = resolve_device(device)
    meshes = []
    for name in query_obj:
        verts, faces, colors, uv, tex = load_obj_file(os.path.join(obj_root, name, mesh_name),
                                                      with_uv=True)
        if dataset_type == "HO3D":
            verts = verts @ _HO3D_CAM_EXTR.T
        verts = center_vert_bbox(verts)
        if verts.shape[0] > max_verts:
            keep = np.linspace(0, verts.shape[0] - 1, max_verts).astype(np.int64)
            remap = np.full(verts.shape[0], -1, np.int64)
            remap[keep] = np.arange(max_verts)
            nearest = keep[np.searchsorted(keep, np.arange(verts.shape[0]).clip(0, keep[-1]))]
            faces = remap[nearest[faces]]
            verts = verts[keep]
            colors = colors[keep] if colors is not None else None
            uv = uv[keep] if uv is not None else None
            faces = faces[(faces >= 0).all(1) & (faces.max(1) != faces.min(1))]
        meshes.append({"verts": verts, "faces": faces, "colors": colors, "uv": uv, "tex": tex,
                       "corners": _bbox_corners(verts)})
    return _pack(meshes, query_obj, device=device)


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
    return _pack(meshes, query_obj, v_max, f_max, 128, device=device)


def get_object_library(query_obj: List[str], dataset_type: str = "HO3D",
                       obj_root: Optional[str] = None, device=None) -> ObjectLibrary:
    """The YCB meshes from the first root that holds a folder for every
    object (``obj_root``, then ``./data/YCB_models_process``, then
    ``./data/DexYCB/models``), else the synthetic library, with a warning
    either way it falls back."""
    device = resolve_device(device)
    roots = ([obj_root] if obj_root else []) + ["./data/YCB_models_process",
                                                "./data/DexYCB/models"]
    for root in roots:
        if root and all(os.path.isdir(os.path.join(root, n)) for n in query_obj):
            try:
                return load_object_library(query_obj, root, dataset_type, device=device)
            except Exception as e:  # a corrupt or partial asset
                logger.warning(f"object asset load failed ({e}); using synthetic library")
                break
    logger.warning("YCB object assets not found; using synthetic object library")
    return synthetic_object_library(query_obj, device=device)
