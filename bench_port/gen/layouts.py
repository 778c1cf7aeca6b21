"""Seeded asset writers in the official on-disk layouts, frozen here so
that a later change to the program cannot move what the benchmark feeds
it. Copied from ``artiboost_torch/datasets/layouts.py`` (``textured_image``,
``_save_image``, ``sphere_mesh``, ``write_obj``, ``write_ycb_models``,
``write_grasps``, ``write_backgrounds``, ``write_html_hands``)."""
from __future__ import annotations

import os
import pickle
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np


def textured_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: a few random sinusoids per channel and +-24 levels
    of noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy, ph = rng.uniform(0.005, 0.05, 2).tolist() + [rng.uniform(0, 6.3)]
        img[..., c] = 128 + 80 * np.sin(fx * x + ph) * np.cos(fy * y - ph)
    img += rng.randint(-24, 25, size=(h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".png"):
        Image.fromarray(img).save(path, compress_level=1)
    else:
        Image.fromarray(img).save(path, quality=90)


def sphere_mesh(n_lat: int, n_lon: int, radii: Iterable[float]):
    """A UV-mapped ellipsoid: (verts (n_lat * n_lon, 3), uvs, faces (F, 3),
    1-based, outward)."""
    rx, ry, rz = radii
    th = np.linspace(0.05, np.pi - 0.05, n_lat)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([rx * np.sin(T) * np.cos(P), ry * np.sin(T) * np.sin(P), rz * np.cos(T)],
                     -1).reshape(-1, 3)
    uvs = np.stack([P / (2 * np.pi), 1 - T / np.pi], -1).reshape(-1, 2)
    faces = []
    for a in range(n_lat - 1):
        for b in range(n_lon):
            p0, p1 = a * n_lon + b, a * n_lon + (b + 1) % n_lon
            faces += [[p0, p0 + n_lon, p1], [p1, p0 + n_lon, p1 + n_lon]]
    return verts, uvs, np.asarray(faces) + 1


def write_obj(path: str, verts, uvs=None, faces=(), mtl: Optional[str] = None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = [f"mtllib {mtl}"] if mtl else []
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    if uvs is not None:
        lines += [f"vt {u:.6f} {v:.6f}" for u, v in uvs]
        lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in faces]
    else:
        lines += [f"f {a} {b} {c}" for a, b, c in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_ycb_models(models_root: str, names: Sequence[str], rng: np.random.RandomState,
                     n_lat: int = 48, n_lon: int = 64, tex_size: int = 1024,
                     mesh_name: str = "ds_textured.obj"):
    """``{models_root}/<name>/{mesh_name, .mtl, texture_map.png}``: a textured
    ellipsoid of n_lat x n_lon vertices per object."""
    for name in names:
        verts, uvs, faces = sphere_mesh(n_lat, n_lon, rng.uniform(0.03, 0.09, 3))
        d = os.path.join(models_root, name)
        mtl = mesh_name.replace(".obj", ".mtl")
        write_obj(os.path.join(d, mesh_name), verts, uvs, faces, mtl=mtl)
        with open(os.path.join(d, mtl), "w") as fh:
            fh.write("newmtl material_0\nmap_Kd texture_map.png\n")
        save_image(os.path.join(d, "texture_map.png"), textured_image(rng, tex_size, tex_size))


def write_grasps(grasp_dir: str, names: Sequence[str], n: int, rng: np.random.RandomState):
    """``{grasp_dir}/<name>.pkl``: a list of ``n`` (pose 48, shape 10, tsl 3)."""
    os.makedirs(grasp_dir, exist_ok=True)
    for name in names:
        grasps = [((rng.randn(48) * 0.3).astype(np.float32),
                   (rng.randn(10) * 0.3).astype(np.float32),
                   (rng.randn(3) * 0.05).astype(np.float32)) for _ in range(n)]
        with open(os.path.join(grasp_dir, name + ".pkl"), "wb") as fh:
            pickle.dump(grasps, fh)


def write_backgrounds(bg_dir: str, n: int, rng: np.random.RandomState,
                      size: Tuple[int, int] = (640, 480)):
    for i in range(n):
        save_image(os.path.join(bg_dir, f"bg_{i:03d}.jpg"), textured_image(rng, size[1], size[0]))


def write_html_hands(html_root: str, ids: Iterable[int], template: np.ndarray,
                     faces: np.ndarray, rng: np.random.RandomState, tex_size: int = 512):
    """``{html_root}/html_<id>/{hand.obj, texture.png}``: the MANO mesh with
    a UV per vertex (the template's x, y) and a texture."""
    lo, hi = template.min(0), template.max(0)
    uvs = (template[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)
    for i in ids:
        d = os.path.join(html_root, f"html_{i:03d}")
        write_obj(os.path.join(d, "hand.obj"), template, uvs, np.asarray(faces) + 1)
        save_image(os.path.join(d, "texture.png"), textured_image(rng, tex_size, tex_size))
