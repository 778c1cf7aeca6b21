"""The plain reference of the synthetic sample (ArtiBoost's rendered
dataset): its 2D and 3D labels, the placement of its scene on the screen,
and its image from the rasterized texture coordinates on.

Labels: the final hand and the object's corners in the camera frame, the
square crop about the root joint and the object's corners (its side 1.2 x
their extent), jittered in centre (0.1 x the side, uniform) and scale
(normal, sigma 0.1 / 3, clipped to 0.9-1.1) and turned about the optical
axis by the drawn angle; the crop's intrinsics; the points projected into
it; a point visible where it lies inside both the raw 512 x 512 frame and
the crop and at least 40 % of its kind do.

Image: the raster's texture coordinates (12 bits each) and page at each
pixel, one texel for each 2 x 2 quad (the nearest to the quad's largest
(page, u, v) key), times the pixel's shade, clipped to [0, 1]; the
foreground doubled in size, over the drawn background's 224 x 224 window
(a 4 x 4 grid of offsets in the 336 x 336 bank image); then the gaussian
blur of the drawn sigma (radius 3, edges repeated) and the colour jitter
(brightness, then contrast about the image's mean, then saturation about
each pixel's grey), clipped, less 0.5. Textures and backgrounds are read
from the asset files and resized bilinearly (256 x 256 and 336 x 336)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from bench_port.reference import engine

CENTER_JIT, SCALE_JIT, BLUR_RADIUS, TEX_SIZE, BG_SIZE = 0.1, 0.1, 3, 256, 336


def _image(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR),
                          np.float32) / 255.0


def load_atlas(root: str, obj_names: List[str], device) -> torch.Tensor:
    """The texture pages: the HTML hands in the order of their folders,
    then the objects in the recipe's order -> (P, 256, 256, 3)."""
    hands = []
    html = os.path.join(root, "data", "HTML_supp")
    for i in range(52):
        d = os.path.join(html, f"html_{i:03d}")
        if i == 2 or not os.path.isfile(os.path.join(d, "hand.obj")):
            continue
        tex = next((os.path.join(d, c) for c in ("texture.png", "texture.jpg", "hand.png",
                                                 "hand.jpg") if os.path.isfile(os.path.join(d, c))),
                   None)
        if tex is not None:
            hands.append(_image(tex, TEX_SIZE))
    objs = [_image(os.path.join(root, "data", "YCB_models_process", n, "texture_map.png"), TEX_SIZE)
            for n in obj_names]
    return torch.as_tensor(np.stack(hands + objs), device=device)


def load_backgrounds(bg_dir: str, device) -> torch.Tensor:
    files = sorted(f for f in os.listdir(bg_dir) if f.endswith((".jpg", ".jpeg", ".png")))[:64]
    return torch.as_tensor(np.stack([_image(os.path.join(bg_dir, f), BG_SIZE) for f in files]),
                           device=device)


def project(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    h = pts @ K.transpose(1, 2)
    return h[..., :2] / torch.clamp_min(h[..., 2:], 1e-8)


def labels(rows: Dict, draws: Dict, corners_can: torch.Tensor, joints: torch.Tensor,
           recipe: Dict, dt) -> Dict:
    """rows: the program's pose cache rows (obj_pose); joints: the final hand
    (B, 21, 3) in the camera frame; draws: the crop's (cjit, sjit, rot) ->
    the sample's labels and its crop intrinsics."""
    rend, preset = recipe["MANAGER"]["RENDERER"], recipe["DATA_PRESET"]
    cam = rend["CAM_PARAM"]
    H = W = int(preset["IMAGE_SIZE"][0])
    raw = int(rend["RENDER_SIZE"][0])
    B = joints.shape[0]
    joints = joints.to(dt)
    pose = rows["obj_pose"].to(dt)
    corners = corners_can.to(dt) @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    K = torch.tensor([[cam["FX"], 0.0, cam["CX"]], [0.0, cam["FY"], cam["CY"]], [0.0, 0.0, 1.0]],
                     dtype=dt, device=joints.device).expand(B, 3, 3)
    j2_raw, c2_raw = project(joints, K), project(corners, K)
    mode = preset.get("CROP_MODEL", "root_obj")
    pts = {"hand": j2_raw, "root_obj": torch.cat([j2_raw[:, :1], c2_raw], 1)}.get(
        mode, torch.cat([j2_raw, c2_raw], 1))
    lo, hi = pts.amin(1), pts.amax(1)
    center = (lo + hi) / 2
    scale = (hi - lo).amax(1) * float(preset["BBOX_EXPAND_RATIO"])
    center = center + CENTER_JIT * scale[:, None] * (draws["cjit"].to(dt) * 2 - 1)
    scale = scale * torch.clamp(draws["sjit"].to(dt) * (SCALE_JIT / 3) + 1, 1 - SCALE_JIT,
                                1 + SCALE_JIT)
    Rz = engine.rot_z(draws["rot"].to(dt))
    oc = torch.tensor([cam["CX"], cam["CY"]], dtype=dt, device=joints.device)
    cen = ((center - oc)[:, None] @ Rz[:, :2, :2].transpose(1, 2))[:, 0] + oc
    A = torch.zeros((B, 3, 3), dtype=dt, device=joints.device)
    A[:, 0, 0], A[:, 1, 1], A[:, 2, 2] = W / scale, H / scale, 1.0
    A[:, 0, 2] = W * (0.5 - cen[:, 0] / scale)
    A[:, 1, 2] = H * (0.5 - cen[:, 1] / scale)
    K_crop = A @ K
    jr, cr = joints @ Rz.transpose(1, 2), corners @ Rz.transpose(1, 2)
    j2, c2 = project(jr, K_crop), project(cr, K_crop)

    def vis(p_raw, p_crop):
        in_raw = ((p_raw >= 0) & (p_raw < raw)).all(-1)
        in_crop = (p_crop[..., 0] >= 0) & (p_crop[..., 0] < W) & (p_crop[..., 1] >= 0) & (
            p_crop[..., 1] < H)
        ok = (in_raw.sum(1) >= 0.4 * p_raw.shape[1]) & (in_crop.sum(1) >= 0.4 * p_raw.shape[1])
        return (in_crop & ok[:, None]).to(dt)

    root = jr[:, int(preset["CENTER_IDX"])]
    return {"joints_3d": jr - root[:, None], "corners_3d": cr - root[:, None], "root_joint": root,
            "joints_2d": j2, "corners_2d": c2, "cam_intr": K_crop,
            "joints_vis": vis(j2_raw, j2), "corners_vis": vis(c2_raw, c2), "rot": Rz}


def screen(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera points -> (x pixels, y pixels, z) under intrinsics K."""
    z = torch.clamp_min(pts[..., 2:], 1e-6)
    return torch.cat([pts[..., :1] / z * K[:, None, 0, 0, None] + K[:, None, 0, 2, None],
                      pts[..., 1:2] / z * K[:, None, 1, 1, None] + K[:, None, 1, 2, None], z], -1)


def image(raster: Dict, draws: Dict, atlas: torch.Tensor, bgs: torch.Tensor, out_size: int,
          rnd=lambda x: x) -> torch.Tensor:
    """The rows' images (B, H, W, 3) from their raster outputs (quv, shade,
    page, depth at the render size) and draws. ``rnd`` rounds the image to
    a precision where the recipe keeps it in bfloat16 (the identity for the
    check, float8 for the control)."""
    quv, shade, page, depth = (raster[k] for k in ("quv", "shade", "page", "depth"))
    B, h, w = quv.shape
    key = page.long() * (1 << 24) + quv.long()
    key = key.reshape(B, h // 2, 2, w // 2, 2).amax(dim=(2, 4))
    pg, q = key >> 24, key & 0xFFFFFF
    T = atlas.shape[1]
    u = torch.div(q, 4096, rounding_mode="floor").float() / 4095.0
    v = (q % 4096).float() / 4095.0
    ix, iy = torch.round(u * (T - 1)).long(), torch.round((1 - v) * (T - 1)).long()
    albedo = atlas[pg, iy, ix].repeat_interleave(2, 1).repeat_interleave(2, 2)
    rgb = torch.clamp(albedo * shade[..., None].float(), 0.0, 1.0)
    r = out_size // h
    rgb = rgb.repeat_interleave(r, 1).repeat_interleave(r, 2)
    fg = (depth > 0).repeat_interleave(r, 1).repeat_interleave(r, 2)
    Hb = bgs.shape[1]
    grid = np.unique(np.linspace(0, Hb - out_size, 4).round().astype(np.int64))
    cell = draws["render"]["bg_pos"].long().cpu().numpy()
    ids = draws["render"]["bg_id"].long()
    bg = torch.stack([bgs[ids[b], grid[cell[b] // len(grid)]:grid[cell[b] // len(grid)] + out_size,
                          grid[cell[b] % len(grid)]:grid[cell[b] % len(grid)] + out_size]
                      for b in range(B)])
    img = rnd(torch.where(fg[..., None], rgb, bg))
    x = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x[None] / torch.clamp_min(draws["sigma"].float()[:, None], 1e-3)) ** 2)
    k = k / k.sum(1, keepdim=True)
    for dim in (1, 2):  # rows, then columns, each edge repeated
        n = img.shape[dim]
        idx = torch.clamp(torch.arange(n, device=img.device)[:, None] + x.long()[None], 0, n - 1)
        taps = img.index_select(dim, idx.reshape(-1)).unflatten(dim, (n, idx.shape[1]))
        shape = [B, 1, 1, 1, 1]
        shape[dim + 1] = -1
        img = rnd((taps * k.reshape(shape)).sum(dim + 1))
    j = draws["jitter"]
    img = rnd(img * j["b"].float())
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = rnd((img - mean) * j["c"].float() + mean)
    grey = img.mean(-1, keepdim=True)
    img = rnd(torch.clamp((img - grey) * j["s"].float() + grey, 0.0, 1.0))
    return img - 0.5
