"""Synthetic scene rendering: hand + object -> training image (counterpart
of ``artiboost_tpu/artiboost/renderer.py``; reference
``anakin/utils/renderer.py``). The parts on the synthesis path: the
asset banks (backgrounds and HTML hand textures loaded from disk, or
synthetic stand-ins), scene composition and render LOD, Lambert shade,
the per-pixel UV raster and the Gouraud raster (kernels in
``ops/rasterizer_cuda.py``), the texel gather (nearest or bilinear), the
horizontal motion blur, the background composite, blur and colour
jitter."""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from artiboost_torch.artiboost.object_library import ObjectLibrary, _resize_tex
from artiboost_torch.mano.model import ManoModel
from artiboost_torch.ops.rasterizer import (
    build_face_incidence,
    project_verts,
    shade_vertices,
    vertex_normals,
    vertex_normals_indexed,
)
from artiboost_torch.ops.rasterizer_cuda import rasterize_batch_rgb, rasterize_batch_uv
from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import device_constant, resolve_device


class RenderAssets(NamedTuple):
    hand_faces: torch.Tensor       # (Fh, 3)
    hand_color_bank: torch.Tensor  # (n_tex, 778, 3)
    backgrounds: torch.Tensor      # (n_bg, Hb, Wb, 3) in [0, 1]
    hand_uvs: Optional[torch.Tensor] = None      # (n_tex, 778, 2)
    hand_textures: Optional[torch.Tensor] = None  # (n_tex, T, T, 3)


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) upsampling weights of a triangle kernel with
    half-pixel centers (the weight matrix of ``jax.image.resize``)."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def synthetic_backgrounds(n_bg: int = 8, size: int = 336, seed: int = 0) -> torch.Tensor:
    """Procedural background bank (bilinearly upsampled 6x6 noise) standing
    in for ``assets/synth_bg``."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(_bilinear_weights(6, size))
    bgs = []
    for _ in range(n_bg):
        lo = torch.from_numpy(rng.rand(6, 6, 3).astype(np.float32))
        img = torch.einsum("hi,hwc->iwc", w, lo)
        img = torch.einsum("wj,iwc->ijc", w, img)
        bgs.append(img.numpy() * 0.8 + 0.1)
    return torch.from_numpy(np.stack(bgs))


def synthetic_hand_color_bank(n_tex: int = 8, seed: int = 0) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    base = np.array([0.80, 0.60, 0.50], np.float32)
    bank = []
    for _ in range(n_tex):
        tone = base * (0.7 + 0.5 * rng.rand(3).astype(np.float32))
        noise = rng.rand(778, 3).astype(np.float32) * 0.06
        bank.append(np.clip(tone + noise, 0.0, 1.0))
    return torch.from_numpy(np.stack(bank))


def synthetic_hand_textures(template: np.ndarray, n_tex: int = 8, T: int = 128,
                            seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Procedural skin textures + template-projected UVs -> (uvs (n_tex,
    778, 2), textures (n_tex, T, T, 3))."""
    rng = np.random.RandomState(seed)
    t = np.asarray(template, np.float32)
    lo, hi = t.min(0), t.max(0)
    uv = (t[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)
    base = np.array([0.80, 0.60, 0.50], np.float32)
    ty, tx = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    texs = []
    for _ in range(n_tex):
        tone = base * (0.7 + 0.5 * rng.rand(3).astype(np.float32))
        low = 0.85 + 0.15 * np.sin(2 * np.pi * tx / 48.0 + rng.rand() * 6) \
            * np.sin(2 * np.pi * ty / 64.0 + rng.rand() * 6)
        fine = 0.95 + 0.1 * rng.rand(T, T).astype(np.float32)
        texs.append(np.clip(tone[None, None] * (low * fine)[..., None], 0, 1))
    uvs = np.tile(uv[None], (n_tex, 1, 1)).astype(np.float32)
    return torch.from_numpy(uvs), torch.from_numpy(np.stack(texs).astype(np.float32))


def load_backgrounds(path: str, size: int = 336, max_n: int = 64) -> Optional[torch.Tensor]:
    """The first ``max_n`` (sorted) JPEG / PNG files under ``path``, each
    resized bilinearly to ``size`` x ``size`` -> (n, size, size, 3) in
    [0, 1], or None when there is none."""
    import glob

    from PIL import Image

    files = sorted(f for ext in ("*.jpg", "*.jpeg", "*.png")
                   for f in glob.glob(os.path.join(path, "**", ext), recursive=True))[:max_n]
    if not files:
        return None
    bgs = []
    for f in files:
        with Image.open(f) as im:
            bgs.append(np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR),
                                  np.float32) / 255.0)
    return torch.from_numpy(np.stack(bgs))


def load_html_hand_assets(html_root: str, n_verts: int = 778, skip_ids: Tuple[int, ...] = (2,),
                          tex_size: int = 256
                          ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The HTML textured hands (``{html_root}/html_{i:03d}/hand.obj`` and
    its texture, i < 52, less ``skip_ids``) -> (vertex-baked colours
    (n, 778, 3), UVs (n, 778, 2), textures (n, T, T, 3)), or None when no
    hand has both UVs and a texture."""
    from PIL import Image

    banks, uv_banks, tex_banks = [], [], []
    for i in range(52):
        if i in skip_ids:
            continue
        d = os.path.join(html_root, f"html_{i:03d}")
        obj_path = os.path.join(d, "hand.obj")
        if not os.path.isfile(obj_path):
            continue
        uvs, v_uv, tex = [], {}, None
        with open(obj_path) as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                if t[0] == "vt":
                    uvs.append((float(t[1]), float(t[2])))
                elif t[0] == "f":
                    for corner in t[1:]:
                        parts = corner.split("/")
                        if len(parts) >= 2 and parts[1]:
                            v_uv.setdefault(int(parts[0]) - 1, int(parts[1]) - 1)
        for cand in ("texture.png", "texture.jpg", "hand.png", "hand.jpg"):
            p = os.path.join(d, cand)
            if os.path.isfile(p):
                with Image.open(p) as im:
                    tex = np.asarray(im.convert("RGB"), np.float32) / 255.0
                break
        if tex is None or not uvs:
            continue
        H, W = tex.shape[:2]
        colors = np.full((n_verts, 3), 0.7, np.float32)
        uv_arr = np.zeros((n_verts, 2), np.float32)
        for v, vt in v_uv.items():
            if v < n_verts and vt < len(uvs):
                u, w = uvs[vt]
                uv_arr[v] = (u, w)
                colors[v] = tex[min(int((1.0 - w) * (H - 1)), H - 1), min(int(u * (W - 1)), W - 1)]
        banks.append(colors)
        uv_banks.append(uv_arr)
        tex_banks.append(_resize_tex(tex, tex_size))
    if not banks:
        return None
    return tuple(torch.from_numpy(np.stack(b)) for b in (banks, uv_banks, tex_banks))


def load_html_hand_colors(html_root: str, n_verts: int = 778,
                          skip_ids: Tuple[int, ...] = (2,)) -> Optional[torch.Tensor]:
    """The vertex-baked colour bank of ``load_html_hand_assets`` alone."""
    assets = load_html_hand_assets(html_root, n_verts, skip_ids)
    return None if assets is None else assets[0]


def default_render_assets(mano_model: ManoModel, n_bg: int = 8, n_tex: int = 8,
                          bg_size: int = 336, bgs_path: Optional[str] = None,
                          html_path: Optional[str] = None, device=None) -> RenderAssets:
    """The backgrounds under ``bgs_path`` and the HTML hands under
    ``html_path`` where they exist, synthetic stand-ins otherwise."""
    device = resolve_device(device)
    backgrounds = load_backgrounds(bgs_path, bg_size) if bgs_path else None
    html = load_html_hand_assets(html_path) if html_path else None
    if html is not None:
        bank, uvs, texs = html
    else:
        bank = synthetic_hand_color_bank(n_tex)
        uvs, texs = synthetic_hand_textures(mano_model.v_template.cpu().numpy(), n_tex)
    if backgrounds is None:
        backgrounds = synthetic_backgrounds(n_bg, size=bg_size)
    return RenderAssets(
        hand_faces=mano_model.faces.to(device), hand_color_bank=bank.to(device),
        backgrounds=backgrounds.to(device), hand_uvs=uvs.to(device),
        hand_textures=texs.to(device))


def compose_scene_arrays(hand_verts, hand_colors, hand_faces, overts_can, ocolors,
                         ofaces, ofvalid, obj_pose):
    """-> (verts (B, V, 3), colors (B, V, 3), faces (B, F, 3), face_valid (B, F))."""
    B = hand_verts.shape[0]
    overts = (torch.einsum("bij,bnj->bni", obj_pose[:, :3, :3], overts_can)
              + obj_pose[:, None, :3, 3])
    verts = torch.cat([hand_verts, overts], dim=1)
    colors = torch.cat([hand_colors, ocolors], dim=1)
    n_hand = hand_verts.shape[1]
    faces = torch.cat([hand_faces[None].expand(B, -1, -1), ofaces + n_hand], dim=1)
    fvalid = torch.cat([torch.ones((B, hand_faces.shape[0]), dtype=torch.float32,
                                   device=hand_verts.device), ofvalid], dim=1)
    return verts, colors, faces, fvalid


class SceneLOD(NamedTuple):
    """Render-only decimated geometry (supervision stays full-res)."""

    hand_rep: torch.Tensor        # (Vh',) into the 778 MANO verts
    hand_faces: torch.Tensor      # (Fh', 3) in rep space
    hand_bank: torch.Tensor       # (n_tex, Vh', 3)
    obj_verts: torch.Tensor       # (n_obj, VL, 3)
    obj_colors: torch.Tensor      # (n_obj, VL, 3)
    obj_faces: torch.Tensor       # (n_obj, FL, 3)
    obj_face_valid: torch.Tensor  # (n_obj, FL)
    incidence: Optional[torch.Tensor]  # (n_obj, Vh'+VL, D)
    hand_uv_bank: Optional[torch.Tensor] = None  # (n_tex, Vh', 2)
    obj_uvs: Optional[torch.Tensor] = None       # (n_obj, VL, 2)


def build_scene_lod(hand_template: np.ndarray, hand_faces: np.ndarray,
                    hand_color_bank: torch.Tensor, obj_lib: ObjectLibrary,
                    target_faces: int, hand_uv_bank: Optional[torch.Tensor] = None,
                    device=None) -> SceneLOD:
    """Decimate hand + every object to <= target_faces each (host numpy)."""
    from artiboost_torch.ops.decimate import decimate_mesh, decimate_topology

    device = resolve_device(device)
    rep, hf = decimate_topology(np.asarray(hand_template), np.asarray(hand_faces),
                                target_faces)
    bank = hand_color_bank.cpu().numpy()[:, rep]
    h_uv = hand_uv_bank.cpu().numpy()[:, rep] if hand_uv_bank is not None else None
    has_uv = obj_lib.uvs is not None
    meshes = []
    for o in range(obj_lib.n_obj):
        fv = obj_lib.face_valid[o].cpu().numpy() > 0
        vv = int(obj_lib.n_verts[o])
        attrs = obj_lib.colors[o].cpu().numpy()[:vv]
        if has_uv:
            attrs = np.concatenate([attrs, obj_lib.uvs[o].cpu().numpy()[:vv]], axis=1)
        meshes.append(decimate_mesh(obj_lib.verts[o].cpu().numpy()[:vv],
                                    obj_lib.faces[o].cpu().numpy()[fv].astype(np.int32),
                                    target_faces, attrs))
    VL = max(m[0].shape[0] for m in meshes)
    FL = max(m[1].shape[0] for m in meshes)
    n = len(meshes)
    overts = np.zeros((n, VL, 3), np.float32)
    ocol = np.full((n, VL, 3), 0.6, np.float32)
    ouv = np.zeros((n, VL, 2), np.float32) if has_uv else None
    ofaces = np.zeros((n, FL, 3), np.int64)
    ofval = np.zeros((n, FL), np.float32)
    for o, (v, f, c) in enumerate(meshes):
        overts[o, :v.shape[0]] = v
        if c is not None:
            ocol[o, :v.shape[0]] = c[:, :3]
            if has_uv:
                ouv[o, :v.shape[0]] = c[:, 3:5]
        ofaces[o, :f.shape[0]] = f
        ofval[o, :f.shape[0]] = 1.0

    n_hand = rep.shape[0]
    tables = [build_face_incidence(np.concatenate([hf, ofaces[o] + n_hand], axis=0),
                                   n_hand + VL) for o in range(n)]
    D = max(t.shape[1] for t in tables)
    F_tot = hf.shape[0] + FL
    inc = None
    if D <= 64:
        inc = np.stack([np.pad(t, ((0, 0), (0, D - t.shape[1])), constant_values=F_tot)
                        for t in tables])
    t = lambda a: None if a is None else torch.as_tensor(a).to(device)
    return SceneLOD(hand_rep=t(rep.astype(np.int64)), hand_faces=t(hf.astype(np.int64)),
                    hand_bank=t(bank), obj_verts=t(overts), obj_colors=t(ocol),
                    obj_faces=t(ofaces), obj_face_valid=t(ofval), incidence=t(inc),
                    hand_uv_bank=t(h_uv), obj_uvs=t(ouv))


def build_scene_incidence(hand_faces: np.ndarray, obj_lib: ObjectLibrary,
                          n_hand: int = 778, device=None) -> torch.Tensor:
    """(n_obj, V_total, D) incidence tables of the full-res composed scene."""
    device = resolve_device(device)
    hf = np.asarray(hand_faces)
    v_total = n_hand + obj_lib.verts.shape[1]
    tables = [build_face_incidence(np.concatenate([hf, obj_lib.faces[o].cpu().numpy() + n_hand]),
                                   v_total) for o in range(obj_lib.faces.shape[0])]
    D = max(t.shape[1] for t in tables)
    F = hf.shape[0] + obj_lib.faces.shape[1]
    return torch.as_tensor(np.stack([
        np.pad(t, ((0, 0), (0, D - t.shape[1])), constant_values=F) for t in tables])).to(device)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Separable gaussian blur with per-sample sigma, (B, H, W, 3),
    edge-padded, dtype-preserving."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x[None, :] / torch.clamp_min(sigma[:, None], 1e-3)) ** 2)
    k = (k / torch.sum(k, dim=1, keepdim=True)).to(img.dtype)  # (B, K)
    H, W = img.shape[1], img.shape[2]
    imh = torch.cat([img[:, :1].expand(-1, radius, -1, -1), img,
                     img[:, -1:].expand(-1, radius, -1, -1)], dim=1)
    out = 0
    for i in range(2 * radius + 1):
        out = out + imh[:, i:i + H] * k[:, i, None, None, None]
    outw = torch.cat([out[:, :, :1].expand(-1, -1, radius, -1), out,
                      out[:, :, -1:].expand(-1, -1, radius, -1)], dim=2)
    res = 0
    for i in range(2 * radius + 1):
        res = res + outw[:, :, i:i + W] * k[:, i, None, None, None]
    return res


def color_jitter_draws(generator: torch.Generator, B: int, device=None, brightness=0.3,
                       contrast=0.3, saturation=0.3) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    def u(x):
        return torch.rand(B, 1, 1, 1, generator=generator, device=device) * (2 * x) + (1 - x)

    return {"b": u(brightness), "c": u(contrast), "s": u(saturation)}


def _color_jitter(img: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    dt = img.dtype
    img = img * draws["b"].to(dt)
    mean = torch.mean(img, dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * draws["c"].to(dt) + mean
    gray = torch.mean(img, dim=-1, keepdim=True)
    img = (img - gray) * draws["s"].to(dt) + gray
    return torch.clamp(img, 0.0, 1.0)


class SceneTextures(NamedTuple):
    """Per-pixel texturing inputs (reference per-fragment GL sampling,
    ``anakin/utils/renderer.py:52-55``)."""

    atlas: torch.Tensor      # (P, T, T, 3) pages: hand bank + objects
    hand_page: torch.Tensor  # (B,) page of hand vertices
    obj_page: torch.Tensor   # (B,) page of object vertices
    uv: torch.Tensor         # (B, V, 2) in [0, 1]
    n_hand_faces: int
    n_hand_verts: int = 778


def shade_intensity(verts: torch.Tensor, normals: torch.Tensor, ambient: float,
                    light_pos: torch.Tensor, light_intensity: torch.Tensor,
                    max_shade: float = 4.0) -> torch.Tensor:
    """Unclipped two-sided Lambert shade per vertex (B, V), bounded at
    ``max_shade`` (the raster packs shade/4 into 16 bits)."""
    to_light = light_pos[None, :, None] - verts[:, None]  # (B, L, V, 3)
    dist2 = torch.sum(to_light * to_light, dim=-1)
    dirn = to_light / torch.clamp_min(torch.sqrt(dist2)[..., None], 1e-8)
    lam = torch.abs(torch.einsum("blvk,bvk->blv", dirn, normals))
    contrib = light_intensity[..., None] * lam / torch.clamp_min(dist2, 1e-4)
    return torch.clamp(ambient + torch.sum(contrib, dim=1), 0.0, max_shade)


def _atlas_rows(atlas: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """rgb888-packed atlas as (P*T*n_win, 128) rows of overlapping
    stride-127 windows (any texel and its +1 neighbour share a row)."""
    P, T = atlas.shape[0], atlas.shape[1]
    n_win = max(1, -(-(T - 1) // 127))
    a8 = torch.floor(torch.clamp(atlas, 0.0, 1.0) * 255.0 + 0.5)
    q = a8[..., 0] * 65536.0 + a8[..., 1] * 256.0 + a8[..., 2]
    qpad = torch.nn.functional.pad(q, (0, (n_win - 1) * 127 + 128 - T))
    rows = torch.stack([qpad[:, :, w * 127:w * 127 + 128] for w in range(n_win)], dim=2)
    return rows.reshape(P * T * n_win, 128), n_win


def sample_textures(uv_packed: torch.Tensor, shade: torch.Tensor, page: torch.Tensor,
                    tex: SceneTextures, bilinear: bool = False, subsample: int = 1
                    ) -> torch.Tensor:
    """Texel gather + shade multiply -> rgb (B, H, W, 3): the nearest
    texel, or with ``bilinear`` the blend of the 2 x 2 texels around the
    sample (columns x0 and x0 + 1 of rows y0 and y0 + 1, each unpacked
    from rgb888, x0 and y0 clipped to T - 2).

    ``subsample`` s > 1 fetches albedo once per s x s quad, picking the
    quad's max (page, uv) pack so a silhouette quad takes a foreground
    texel, then nearest-upsamples; shade stays per pixel."""
    P, T = tex.atlas.shape[0], tex.atlas.shape[1]
    if P > 128:
        raise ValueError(f"texture atlas has {P} pages; the quad pack supports <= 128")
    if subsample > 1:
        s = subsample
        B_, H_, W_ = page.shape
        if H_ % s or W_ % s:
            raise ValueError(f"subsample {s} must divide the image {H_}x{W_}")
        ci = (page.to(torch.int32) << 24) | uv_packed.to(torch.int32)
        ci = ci.reshape(B_, H_ // s, s, W_ // s, s).amax(dim=4).amax(dim=2)
        page = ci >> 24
        uv_packed = (ci & 0x00FFFFFF).float()
    rows, n_win = _atlas_rows(tex.atlas)
    fl = torch.floor(uv_packed * (1.0 / 4096.0))
    u = fl * (1.0 / 4095.0)
    v = (uv_packed - fl * 4096.0) * (1.0 / 4095.0)
    tx, ty = u * (T - 1), (1.0 - v) * (T - 1)
    pflat = page.reshape(-1).long()

    def fetch(iy, ix):  # the packed texel at (row iy, column ix) of each pixel's page
        win = torch.clamp(torch.div(ix, 127, rounding_mode="floor"), max=n_win - 1)
        return rows[(pflat * T + iy) * n_win + win, ix - win * 127]

    def unpack(qv):
        r8 = torch.floor(qv * (1.0 / 65536.0))
        g8 = torch.floor((qv - r8 * 65536.0) * (1.0 / 256.0))
        return torch.stack([r8, g8, qv - r8 * 65536.0 - g8 * 256.0], -1)

    if not bilinear:
        albedo = unpack(fetch(torch.round(ty).long().reshape(-1),
                              torch.round(tx).long().reshape(-1)))
    else:
        x0 = torch.clamp(torch.floor(tx).long(), 0, T - 2)
        y0 = torch.clamp(torch.floor(ty).long(), 0, T - 2)
        wx = torch.clamp(tx - x0, 0.0, 1.0).reshape(-1, 1)
        wy = torch.clamp(ty - y0, 0.0, 1.0).reshape(-1, 1)
        x0, y0 = x0.reshape(-1), y0.reshape(-1)

        def blend_row(iy):
            return (1.0 - wx) * unpack(fetch(iy, x0)) + wx * unpack(fetch(iy, x0 + 1))

        albedo = (1.0 - wy) * blend_row(y0) + wy * blend_row(y0 + 1)
    albedo = albedo.reshape(page.shape + (3,)) * (1.0 / 255.0)
    if subsample > 1:
        albedo = albedo.repeat_interleave(subsample, 1).repeat_interleave(subsample, 2)
    return torch.clamp(albedo * shade[..., None], 0.0, 1.0)


def motion_blur_h(img: torch.Tensor, k: int) -> torch.Tensor:
    """Horizontal box blur of width k, edge-padded, (B, H, W, 3): the
    reference's motion-blur kernel is a centred horizontal line of ones / k
    (``anakin/utils/renderer.py:32-37``)."""
    r = k // 2
    W = img.shape[2]
    pad = torch.cat([img[:, :, :1].expand(-1, -1, r, -1), img,
                     img[:, :, -1:].expand(-1, -1, k - 1 - r, -1)], dim=2)
    out = pad[:, :, 0:W]
    for i in range(1, k):
        out = out + pad[:, :, i:i + W]
    return out * (1.0 / k)


def background_grid(n_bg_h: int, n_bg_w: int, height: int, width: int):
    """The 4 x 4 grid of crop offsets (deduplicated) in a background image."""
    gy = np.unique(np.linspace(0, n_bg_h - height, 4).round().astype(np.int64))
    gx = np.unique(np.linspace(0, n_bg_w - width, 4).round().astype(np.int64))
    return gy, gx


def render_draws(generator: torch.Generator, B: int, n_bg: int, n_grid: int,
                 device=None, motion_blur: bool = False) -> Dict[str, torch.Tensor]:
    """Random half of ``render_scene``: light intensity U(1, 5) (B, 1),
    background grid cell and background id (B,), and with ``motion_blur``
    then a U(0, 1) draw (B,) that ``motion_blur_prob`` thresholds (drawn
    last, so the other draws do not depend on the option)."""
    device = resolve_device(device)
    out = {"light": torch.rand(B, 1, generator=generator, device=device) * 4.0 + 1.0,
           "bg_pos": torch.randint(0, n_grid, (B,), generator=generator, device=device),
           "bg_id": torch.randint(0, n_bg, (B,), generator=generator, device=device)}
    if motion_blur:
        out["mb"] = torch.rand(B, generator=generator, device=device)
    return out


def render_scene(verts: torch.Tensor, colors: torch.Tensor, faces: torch.Tensor,
                 face_valid: torch.Tensor, intr: torch.Tensor, backgrounds: torch.Tensor,
                 draws: Dict[str, torch.Tensor], height: int, width: int,
                 ambient: float = 0.8, cull_backfaces: bool = True,
                 incidence: Optional[torch.Tensor] = None,
                 texturing: Optional[SceneTextures] = None, bilinear: bool = False,
                 tex_subsample: int = 1, motion_blur: int = 0, motion_blur_prob: float = 1.0,
                 out_size: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shade + rasterize + composite -> (rgb (B, H, W, 3), depth). With
    ``texturing`` the UV kernel interpolates (u, v, shade, page) and the
    texels are gathered after it; without, the vertices are Gouraud-shaded
    and the rgb kernel interpolates their colours. ``motion_blur`` k > 1
    blurs the raw render of each sample whose ``draws["mb"]`` is below
    ``motion_blur_prob`` by a horizontal box of width k, before the
    upsample and the background composite (reference renderer.py:113-116)."""
    light_int = draws["light"] * 0.05
    if incidence is not None:
        normals = vertex_normals_indexed(verts, faces, incidence)
    else:
        normals = vertex_normals(verts, faces)
    light_pos = device_constant(((0.3, -0.3, -0.3),), verts.device)
    vs = project_verts(verts, intr)
    if texturing is not None:
        s = shade_intensity(verts, normals, ambient, light_pos, light_int)
        is_hand = torch.arange(verts.shape[1], device=verts.device)[None, :] < texturing.n_hand_verts
        vp = torch.where(is_hand, texturing.hand_page[:, None].float(),
                         texturing.obj_page[:, None].float())
        attrs = torch.cat([texturing.uv, s[..., None], vp[..., None]], dim=-1)
        quv, sh, pg, _win, depth = rasterize_batch_uv(vs, attrs, faces, face_valid, height,
                                                      width, cull_backfaces=cull_backfaces)
        with profiling.trace("synth/texture"):
            rgb = sample_textures(quv, sh, pg, texturing, bilinear=bilinear,
                                  subsample=tex_subsample)
    else:
        shaded = shade_vertices(verts, normals, colors, ambient, light_pos, light_int,
                                torch.ones((1, 3), device=verts.device))
        rgb, depth = rasterize_batch_rgb(vs, shaded, faces, face_valid, height, width,
                                         cull_backfaces=cull_backfaces)

    if motion_blur > 1:
        apply = draws["mb"] < motion_blur_prob
        rgb = torch.where(apply[:, None, None, None], motion_blur_h(rgb, motion_blur), rgb)

    if out_size is not None and tuple(out_size) != (height, width):
        oh, ow = out_size
        if oh % height or ow % width:
            raise ValueError(f"out_size {out_size} is not a multiple of {(height, width)}")
        ry, rx = oh // height, ow // width
        rgb = rgb.repeat_interleave(ry, 1).repeat_interleave(rx, 2)
        depth = depth.repeat_interleave(ry, 1).repeat_interleave(rx, 2)
        height, width = oh, ow

    # background crop at one of a 4 x 4 grid of offsets (reference
    # renderer.py:111-136 crops a random window of the 1.5x bank image)
    _, Hb, Wb, _ = backgrounds.shape
    gy, gx = background_grid(Hb, Wb, height, width)
    gy = device_constant(tuple(gy.tolist()), verts.device, torch.int64)
    gx = device_constant(tuple(gx.tolist()), verts.device, torch.int64)
    cid = draws["bg_pos"]
    oy = gy[torch.div(cid, len(gx), rounding_mode="floor")]
    ox = gx[cid % len(gx)]
    rows = oy[:, None] + torch.arange(height, device=verts.device)
    cols = ox[:, None] + torch.arange(width, device=verts.device)
    bg = backgrounds[draws["bg_id"][:, None, None], rows[:, :, None], cols[:, None, :]]
    return torch.where((depth > 0)[..., None], rgb, bg), depth
