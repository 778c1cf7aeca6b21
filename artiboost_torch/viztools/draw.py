"""Qualitative visualisation (counterpart of ``artiboost_tpu/viztools/draw.py``;
reference ``anakin/viztools/draw.py`` and ``opendr_renderer.py``): 2D
skeleton and corner-cube overlays and a wireframe drawn with PIL, the
solid-shaded mesh overlay rasterized by the Gouraud raster (kernel B2 on
the card, its plain twin on the CPU), and 3D matplotlib figures."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw

from artiboost_torch.ops.rasterizer import project_verts, shade_vertices, vertex_normals
from artiboost_torch.ops.rasterizer_cuda import rasterize_batch_rgb
from artiboost_torch.utils.misc import CONST, resolve_device

# one colour per finger (thumb, index, middle, ring, pinky)
FINGER_COLORS = ["#e6194b", "#3cb44b", "#4363d8", "#f58231", "#911eb4"]
CORNER_COLOR = "#00ffff"


def project_points(pts3d: np.ndarray, intr: np.ndarray) -> np.ndarray:
    """Perspective-project camera-space points (N, 3) with intrinsics (3, 3)."""
    hom = intr @ pts3d.T  # (3, N)
    return (hom[:2] / np.maximum(hom[2:], 1e-8)).T


def draw_skeleton_2d(img: Image.Image, joints_2d: np.ndarray,
                     point_radius: int = 2, width: int = 2) -> Image.Image:
    """The 21-joint hand skeleton, bones coloured by finger."""
    draw = ImageDraw.Draw(img)
    parents = CONST.JOINTS_IDX_PARENTS
    for i in range(1, 21):
        draw.line([tuple(joints_2d[parents[i]]), tuple(joints_2d[i])],
                  fill=FINGER_COLORS[(i - 1) // 4], width=width)
    for x, y in joints_2d[:21]:
        draw.ellipse([x - point_radius, y - point_radius, x + point_radius, y + point_radius],
                     fill="#ffffff")
    return img


def draw_corners_2d(img: Image.Image, corners_2d: np.ndarray, color: str = CORNER_COLOR,
                    width: int = 2, link_order: Optional[Sequence[int]] = None) -> Image.Image:
    """The 8-corner object bounding cube as a wireframe."""
    draw = ImageDraw.Draw(img)
    pairs = (list(zip(link_order[:-1], link_order[1:])) if link_order is not None
             else CONST.CORNERCUBE_IDX_ORDER)
    for a, b in pairs:
        draw.line([tuple(corners_2d[a]), tuple(corners_2d[b])], fill=color, width=width)
    return img


def draw_mesh_wireframe(img: Image.Image, verts: np.ndarray, faces: np.ndarray,
                        intr: np.ndarray, color: str = "#80d0ff",
                        max_edges: int = 4000) -> Image.Image:
    """Back-to-front wireframe of a camera-space mesh, its faces
    subsampled to ``max_edges`` when the mesh is denser."""
    v2d = project_points(verts, intr)
    depth = verts[:, 2]
    faces = np.asarray(faces)
    if len(faces) > max_edges:
        faces = faces[np.linspace(0, len(faces) - 1, max_edges).astype(int)]
    order = np.argsort(-depth[faces].mean(axis=1))  # far first
    draw = ImageDraw.Draw(img)
    for f in faces[order]:
        a, b, c = v2d[f[0]], v2d[f[1]], v2d[f[2]]
        draw.line([tuple(a), tuple(b), tuple(c), tuple(a)], fill=color, width=1)
    return img


def render_mesh_overlay(img: Image.Image, meshes, intr: np.ndarray, alpha: float = 0.65,
                        ambient: float = 0.55, light_intensity: float = 0.06,
                        device=None) -> Image.Image:
    """Solid-shaded meshes blended over ``img`` in place (the reference
    renders filled hand and object meshes over its eval images with
    OpenDR, ``anakin/submit/hodata_submit_epoch_pass.py:158-222``).

    ``meshes``: (verts_cam (V, 3), faces (F, 3), rgb in [0, 1]) triples,
    rasterized as one scene so the depth test resolves hand-object
    occlusion; a point light at the camera. The Gouraud raster quantises
    the colour to 8 bits before the blend (JAX's plain raster does not).
    ``device``: where it rasterizes, the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    W, H = img.size
    all_v, all_c, all_f, off = [], [], [], 0
    for verts, faces, color in meshes:
        verts = np.asarray(verts, np.float32)
        all_v.append(verts)
        all_c.append(np.tile(np.asarray(color, np.float32)[None], (verts.shape[0], 1)))
        all_f.append(np.asarray(faces, np.int64) + off)
        off += verts.shape[0]
    verts = torch.from_numpy(np.concatenate(all_v))[None].to(device)
    colors = torch.from_numpy(np.concatenate(all_c))[None].to(device)
    faces = torch.from_numpy(np.concatenate(all_f))[None].to(device)
    intr_t = torch.as_tensor(np.asarray(intr, np.float32))[None].to(device)
    shaded = shade_vertices(verts, vertex_normals(verts, faces), colors, ambient,
                            torch.zeros((1, 3), device=device),
                            torch.full((1, 1), light_intensity, device=device),
                            torch.ones((1, 3), device=device))
    rgb, depth = rasterize_batch_rgb(project_verts(verts, intr_t), shaded, faces, None, H, W)
    rgb = rgb[0].cpu().numpy()
    mask = (depth[0].cpu().numpy() > 0)[..., None].astype(np.float32) * alpha
    base = np.asarray(img, np.float32) / 255.0
    out = base * (1.0 - mask) + rgb * mask
    img.paste(Image.fromarray((out * 255).clip(0, 255).astype(np.uint8)))
    return img


def plot_skeleton_3d(joints_3d: np.ndarray, corners_3d: Optional[np.ndarray] = None,
                     save_path: Optional[str] = None):
    """3D matplotlib figure of the hand skeleton and, given, the corner cube;
    saved and closed with ``save_path``, else returned."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    _plot_bones(ax, joints_3d, corners_3d)
    ax.scatter(joints_3d[:, 0], joints_3d[:, 1], joints_3d[:, 2], s=8, c="k")
    return _finish(fig, ax, save_path)


def plot_mesh_3d(verts: np.ndarray, faces: np.ndarray, joints_3d: Optional[np.ndarray] = None,
                 corners_3d: Optional[np.ndarray] = None, save_path: Optional[str] = None,
                 color: str = "#c9a186"):
    """3D figure of a hand or object mesh with, given, the skeleton and the
    corner cube (the matplotlib stand-in for the reference's mayavi
    ``viz_hand_object``, ``anakin/viztools/draw.py:236``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    verts = np.asarray(verts)
    ax.plot_trisurf(verts[:, 0], verts[:, 1], verts[:, 2], triangles=np.asarray(faces),
                    color=color, edgecolor="none", alpha=0.95, shade=True)
    _plot_bones(ax, joints_3d, corners_3d)
    return _finish(fig, ax, save_path)


def _plot_bones(ax, joints_3d, corners_3d) -> None:
    if joints_3d is not None:
        parents = CONST.JOINTS_IDX_PARENTS
        for i in range(1, 21):
            seg = joints_3d[[parents[i], i]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=FINGER_COLORS[(i - 1) // 4])
    if corners_3d is not None:
        for a, b in CONST.CORNERCUBE_IDX_ORDER:
            seg = corners_3d[[a, b]]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=CORNER_COLOR)


def _finish(fig, ax, save_path):
    import matplotlib.pyplot as plt

    ax.set_box_aspect([1, 1, 1])
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def image_grid(images: Sequence[np.ndarray], ncol: int = 4) -> Image.Image:
    """Tile uint8 (H, W, 3) images into one grid image."""
    nrow = (len(images) + ncol - 1) // ncol
    H, W = images[0].shape[:2]
    grid = Image.new("RGB", (ncol * W, nrow * H))
    for i, im in enumerate(images):
        grid.paste(Image.fromarray(np.asarray(im)), ((i % ncol) * W, (i // ncol) * H))
    return grid
