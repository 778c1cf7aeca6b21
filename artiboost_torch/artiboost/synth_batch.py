"""Generated poses -> training sample batches (counterpart of
``artiboost_tpu/artiboost/synth_batch.py``; reference
``anakin/artiboost/rendered_dataset.py`` __getitem__ :155-274): crop
around hand/object folded into the camera (render-at-crop), quad-rate
foreground raster, visibility >= 40 % rules, blur / colour jitter,
normalization and the Queries/SynthQueries sample schema. The foreground
is textured per pixel (the uv raster, then the texel gather) when
``textured`` is set and every texture asset exists, as in JAX; otherwise
its vertices carry the colour banks and the Gouraud raster draws it."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from artiboost_torch.artiboost.object_library import ObjectLibrary, _resize_tex
from artiboost_torch.artiboost.pose_generator import (
    GeneratedPoses,
    decode_final_hand,
    rotate_hand_global,
)
from artiboost_torch.artiboost.renderer import (
    RenderAssets,
    SceneTextures,
    _color_jitter,
    _gaussian_blur,
    background_grid,
    build_scene_incidence,
    build_scene_lod,
    color_jitter_draws,
    compose_scene_arrays,
    render_draws,
    render_scene,
)
from artiboost_torch.datasets.hoquery import Queries, SynthQueries
from artiboost_torch.mano.model import ManoModel
from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import CONST, device_constant, logger, resolve_device
from artiboost_torch.utils.transform import batch_persp_proj2d, get_affine_trans_no_rot


class SynthConfig(NamedTuple):
    image_size: int = 224
    raw_size: int = 512
    fx: float = 435.0
    fy: float = 435.0
    cx: float = 256.0
    cy: float = 256.0
    bbox_expand_ratio: float = 1.2
    crop_model: str = "root_obj"
    center_idx: int = 0
    aug: bool = True
    center_jit: float = 0.1
    scale_jit: float = 0.1
    max_rot: float = 0.2
    blur_max_sigma: float = 1.0
    motion_blur: int = 0           # width of the horizontal box blur; 0: off
    motion_blur_prob: float = 1.0  # the share of samples it blurs
    cull_backfaces: bool = True
    lod_faces: int = -1        # -1 auto: 128 per component at <= 256 px, else off
    textured: bool = True      # per-pixel UV texturing where every texture asset exists
    bilinear: bool = False     # bilinear texel gather (else nearest)
    tex_subsample: int = 2     # albedo fetched once per s x s quad
    image_bf16: bool = False   # the loader passes its default True
    render_scale: Optional[int] = None  # None auto: 2 when the crop divides


def _annot_center_scale(pts2d: torch.Tensor):
    lo = pts2d.amin(dim=1)
    hi = pts2d.amax(dim=1)
    return (lo + hi) / 2.0, (hi - lo).amax(dim=1)


def _rot_z(rot_rad: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(rot_rad), torch.sin(rot_rad)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


class SynthBatch:
    """synth(gen, idx, draws) -> sample dict; ``draws(generator, B)`` is
    the random half (crop jitter, texture id, light, background, blur,
    colour jitter)."""

    def __init__(self, mano_model: ManoModel, obj_lib: ObjectLibrary, assets: RenderAssets,
                 cfg: SynthConfig, device=None):
        self.mano_model, self.obj_lib, self.assets, self.cfg = mano_model, obj_lib, assets, cfg
        self.device = resolve_device(device)
        H = W = cfg.image_size
        self.raw_intr = torch.tensor([[cfg.fx, 0.0, cfg.cx], [0.0, cfg.fy, cfg.cy],
                                      [0.0, 0.0, 1.0]], device=self.device)
        self.textured = (cfg.textured and assets.hand_textures is not None
                         and assets.hand_uvs is not None and obj_lib.textures is not None
                         and obj_lib.uvs is not None)
        self.atlas, self.n_hand_tex = None, 0
        if self.textured:
            hand_texs = assets.hand_textures.cpu().numpy()
            obj_texs = obj_lib.textures.cpu().numpy()
            T = max(hand_texs.shape[1], obj_texs.shape[1])
            self.atlas = torch.as_tensor(np.stack(
                [_resize_tex(t, T) for t in hand_texs] + [_resize_tex(t, T) for t in obj_texs]
            )).to(self.device)
            self.n_hand_tex = hand_texs.shape[0]

        lod_faces = cfg.lod_faces
        if lod_faces < 0:
            lod_faces = 128 if cfg.image_size <= 256 else 0
        self.lod = None
        self.scene_inc = None
        if lod_faces > 0:
            self.lod = build_scene_lod(
                mano_model.v_template.cpu().numpy(), assets.hand_faces.cpu().numpy(),
                assets.hand_color_bank, obj_lib, lod_faces,
                hand_uv_bank=assets.hand_uvs if self.textured else None, device=self.device)
            logger.info(f"render LOD: hand {assets.hand_faces.shape[0]} -> "
                        f"{self.lod.hand_faces.shape[0]} faces, objects "
                        f"{obj_lib.faces.shape[1]} -> {self.lod.obj_faces.shape[1]} "
                        f"(budget {lod_faces})")
        else:
            inc = build_scene_incidence(assets.hand_faces.cpu().numpy(), obj_lib,
                                        device=self.device)
            self.scene_inc = inc if inc.shape[2] <= 64 else None
        if cfg.render_scale in (None, 0):
            self.rs = 2 if (H % 2 == 0 and W % 2 == 0) else 1
        else:
            self.rs = max(int(cfg.render_scale), 1)
        _, Hb, Wb, _ = assets.backgrounds.shape
        gy, gx = background_grid(Hb, Wb, H, W)
        self.n_bg_grid = len(gy) * len(gx)

    def draws(self, generator: torch.Generator, B: int) -> Dict:
        dev, cfg = self.device, self.cfg
        return {
            "cjit": torch.rand(B, 2, generator=generator, device=dev),
            "sjit": torch.randn(B, generator=generator, device=dev),
            "rot": torch.rand(B, generator=generator, device=dev) * (2 * cfg.max_rot) - cfg.max_rot,
            "tex_id": torch.randint(0, self.assets.hand_color_bank.shape[0], (B,),
                                    generator=generator, device=dev),
            "render": render_draws(generator, B, self.assets.backgrounds.shape[0],
                                   self.n_bg_grid, dev, motion_blur=cfg.motion_blur > 1),
            "sigma": torch.rand(B, generator=generator, device=dev),
            "jitter": color_jitter_draws(generator, B, dev),
        }

    def __call__(self, gen: GeneratedPoses, idx: torch.Tensor, draws: Dict) -> Dict:
        cfg, lib, lod = self.cfg, self.obj_lib, self.lod
        B = idx.shape[0]
        H = W = cfg.image_size

        with profiling.trace("synth/batch"):
            with profiling.trace("synth/hand"):
                hand = decode_final_hand(self.mano_model, gen, idx)
            with profiling.trace("synth/scene"):
                joints_3d, hand_verts = hand["joints"], hand["hand_verts"]
                oid, vid, gid = gen.obj_id[idx], gen.persp_id[idx], gen.grasp_id[idx]
                obj_pose = gen.obj_pose[idx]
                corners_can = lib.corners_can[oid]
                corners_3d = (torch.einsum("bij,bnj->bni", obj_pose[:, :3, :3], corners_can)
                              + obj_pose[:, None, :3, 3])
                intr_b = self.raw_intr[None].expand(B, 3, 3)
                joints_2d_raw = batch_persp_proj2d(joints_3d, intr_b)
                corners_2d_raw = batch_persp_proj2d(corners_3d, intr_b)

                # ---- crop (rendered_dataset :276-304) ----
                if cfg.crop_model == "hand":
                    crop_pts = joints_2d_raw
                elif cfg.crop_model == "root_obj":
                    crop_pts = torch.cat([joints_2d_raw[:, :1], corners_2d_raw], dim=1)
                else:
                    crop_pts = torch.cat([joints_2d_raw, corners_2d_raw], dim=1)
                bbox_center, bbox_scale = _annot_center_scale(crop_pts)
                bbox_scale = bbox_scale * cfg.bbox_expand_ratio
                rot_rad = torch.zeros((B,), device=idx.device)
                if cfg.aug:
                    cjit = draws["cjit"] * 2.0 - 1.0
                    bbox_center = bbox_center + cfg.center_jit * bbox_scale[:, None] * cjit
                    sjit = torch.clamp(draws["sjit"] * (cfg.scale_jit / 3.0) + 1.0,
                                       1.0 - cfg.scale_jit, 1.0 + cfg.scale_jit)
                    bbox_scale = bbox_scale * sjit
                    rot_rad = draws["rot"]

                # in-plane rotation about the optical axis = rotate the scene; the
                # crop center moves with it about the optical center
                rot_mat = _rot_z(rot_rad)
                c, s = torch.cos(rot_rad), torch.sin(rot_rad)
                oc = device_constant((cfg.cx, cfg.cy), idx.device)
                cen = bbox_center - oc
                cen_rot = torch.stack([c * cen[:, 0] - s * cen[:, 1],
                                       s * cen[:, 0] + c * cen[:, 1]], -1) + oc
                new_intr = get_affine_trans_no_rot(cen_rot, bbox_scale, (W, H)) @ intr_b

                joints_3d_r = torch.einsum("bij,bnj->bni", rot_mat, joints_3d)
                corners_3d_r = torch.einsum("bij,bnj->bni", rot_mat, corners_3d)
                hand_verts_r = torch.einsum("bij,bnj->bni", rot_mat, hand_verts)
                obj_pose_r = obj_pose.clone()
                obj_pose_r[:, :3] = rot_mat @ obj_pose[:, :3]

                tex_id = draws["tex_id"]
                if lod is not None:
                    verts, colors, faces, fvalid = compose_scene_arrays(
                        hand_verts_r[:, lod.hand_rep], lod.hand_bank[tex_id], lod.hand_faces,
                        lod.obj_verts[oid], lod.obj_colors[oid], lod.obj_faces[oid],
                        lod.obj_face_valid[oid], obj_pose_r)
                    inc = None if lod.incidence is None else lod.incidence[oid]
                    if self.textured:
                        uv = torch.cat([lod.hand_uv_bank[tex_id], lod.obj_uvs[oid]], dim=1)
                        n_hand_faces = lod.hand_faces.shape[0]
                        n_hand_verts = lod.hand_uv_bank.shape[1]
                else:
                    verts, colors, faces, fvalid = compose_scene_arrays(
                        hand_verts_r, self.assets.hand_color_bank[tex_id], self.assets.hand_faces,
                        lib.verts[oid], lib.colors[oid], lib.faces[oid], lib.face_valid[oid],
                        obj_pose_r)
                    inc = None if self.scene_inc is None else self.scene_inc[oid]
                    if self.textured:
                        uv = torch.cat([self.assets.hand_uvs[tex_id], lib.uvs[oid]], dim=1)
                        n_hand_faces = self.assets.hand_faces.shape[0]
                        n_hand_verts = self.assets.hand_uvs.shape[1]
                texturing = None
                if self.textured:
                    texturing = SceneTextures(atlas=self.atlas, hand_page=tex_id,
                                              obj_page=self.n_hand_tex + oid, uv=uv,
                                              n_hand_faces=int(n_hand_faces),
                                              n_hand_verts=int(n_hand_verts))

                rs = self.rs
                if rs > 1:
                    # quad-rate raster: the foreground renders at (H/rs, W/rs) and is
                    # nearest-upsampled before the full-res background composite
                    scale_mat = device_constant(((1.0 / rs, 0.0, 0.0), (0.0, 1.0 / rs, 0.0),
                                                 (0.0, 0.0, 1.0)), idx.device)
                    render_intr, rH, rW = scale_mat @ new_intr, H // rs, W // rs
                else:
                    render_intr, rH, rW = new_intr, H, W
            with profiling.trace("synth/render"):
                img, _depth = render_scene(
                    verts, colors, faces, fvalid, render_intr, self.assets.backgrounds,
                    draws["render"], rH, rW, cull_backfaces=cfg.cull_backfaces, incidence=inc,
                    texturing=texturing, bilinear=cfg.bilinear, tex_subsample=cfg.tex_subsample,
                    motion_blur=cfg.motion_blur, motion_blur_prob=cfg.motion_blur_prob,
                    out_size=(H, W) if rs > 1 else None)

            with profiling.trace("synth/post"):
                if cfg.image_bf16:
                    img = img.to(torch.bfloat16)
                if cfg.aug:
                    img = _gaussian_blur(img, draws["sigma"] * cfg.blur_max_sigma)
                    img = _color_jitter(img, draws["jitter"])

                joints_2d = batch_persp_proj2d(joints_3d_r, new_intr)
                corners_2d = batch_persp_proj2d(corners_3d_r, new_intr)

                def vis_rule(pts_raw, pts_crop, n, thresh):
                    in_raw = ((pts_raw[..., 0] >= 0) & (pts_raw[..., 0] < cfg.raw_size)
                              & (pts_raw[..., 1] >= 0) & (pts_raw[..., 1] < cfg.raw_size)).float()
                    in_crop = ((pts_crop[..., 0] >= 0) & (pts_crop[..., 0] < W)
                               & (pts_crop[..., 1] >= 0) & (pts_crop[..., 1] < H)).float()
                    raw_ok = in_raw.sum(1, keepdim=True) >= n * thresh
                    crop_ok = in_crop.sum(1, keepdim=True) >= n * thresh
                    return torch.where(raw_ok & crop_ok, in_crop, 0.0)

                joints_vis = vis_rule(joints_2d_raw, joints_2d, CONST.NUM_JOINTS, 0.4)
                corners_vis = vis_rule(corners_2d_raw, corners_2d, CONST.NUM_CORNERS, 0.4)
                root_joint = joints_3d_r[:, cfg.center_idx]

                # the refined MANO pose re-expressed in the final camera frame
                # (roll + in-plane aug rotation folded into the global rotation)
                rot_total = rot_mat @ gen.cam_free[idx]
                hand_pose_final, _ = rotate_hand_global(
                    self.mano_model, rot_total, gen.hand_pose[idx], gen.hand_shape[idx],
                    gen.hand_tsl[idx] + gen.cam_offset[idx])
                overts_3d = (torch.einsum("bij,bnj->bni", obj_pose_r[:, :3, :3], lib.verts[oid])
                             + obj_pose_r[:, None, :3, 3])
                root = root_joint[:, None]
                return {
                    Queries.IMAGE: img - 0.5,
                    Queries.CAM_INTR: new_intr,
                    Queries.JOINTS_3D: joints_3d_r - root,
                    Queries.JOINTS_2D: joints_2d,
                    Queries.ROOT_JOINT: root_joint,
                    Queries.JOINTS_VIS: joints_vis,
                    Queries.CORNERS_3D: corners_3d_r - root,
                    Queries.CORNERS_2D: corners_2d,
                    Queries.CORNERS_CAN: corners_can,
                    Queries.CORNERS_VIS: corners_vis,
                    Queries.OBJ_TRANSF: obj_pose_r,
                    Queries.OBJ_IDX: oid + 1,
                    Queries.OBJ_VERTS_CAN: lib.verts[oid],
                    Queries.OBJ_VERTS_3D: overts_3d - root,
                    Queries.PADDING_MASK: lib.vert_valid[oid],
                    Queries.SAMPLE_IDX: idx,
                    Queries.HAND_VERTS_3D: hand_verts_r - root,
                    Queries.HAND_POSE: hand_pose_final,
                    Queries.HAND_SHAPE: gen.hand_shape[idx],
                    SynthQueries.IS_SYNTH: torch.ones((B,), dtype=torch.int32, device=idx.device),
                    SynthQueries.OBJ_ID: oid,
                    SynthQueries.PERSP_ID: vid,
                    SynthQueries.GRASP_ID: gid,
                }
