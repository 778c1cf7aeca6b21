"""SyntheticHO: a deterministic stand-in for the real HO3D / DexYCB data,
made by the port's own pose generator and Gouraud renderer at init
(counterpart of ``artiboost_tpu/datasets/synthetic.py``), and
``build_dataset``, the ``DATASET.TRAIN`` / ``TEST`` builder over it and the
real-data loaders (``ho3d.py``, ``dexycb.py``, ``fhb.py``).

The random half of the init is split out (``synthetic_ho_draws``): the
(obj, view, grasp) ids, the pose draws (view jitter, ``naive`` scrambler),
the hand colour ids and one set of render draws per chunk of 16 images.
The images are rendered by the Gouraud raster kernel (``raster_rgb``) and
kept as uint8 on the device; the annotations stay on the host for the
numpy geometry of ``HODataset``."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from artiboost_torch.artiboost.grasp_library import synthetic_grasp_library
from artiboost_torch.artiboost.object_library import synthetic_object_library
from artiboost_torch.artiboost.pose_generator import (
    PoseGenerator,
    decode_final_hand,
    rotate_hand_global,
)
from artiboost_torch.artiboost.refiner import build_refiner
from artiboost_torch.artiboost.renderer import (
    background_grid,
    compose_scene_arrays,
    default_render_assets,
    render_draws,
    render_scene,
)
from artiboost_torch.artiboost.scrambler import Scrambler
from artiboost_torch.artiboost.view_engine import ViewEngineConfig
from artiboost_torch.datasets.dexycb import DexYCB  # noqa: F401  (the real-data types register)
from artiboost_torch.datasets.fhb import FPHB  # noqa: F401
from artiboost_torch.datasets.ho3d import HO3D, HO3DV3  # noqa: F401
from artiboost_torch.datasets.hodata import HODataset
from artiboost_torch.mano.model import get_mano_model
from artiboost_torch.utils.registry import DATASET, build_from_cfg

RENDER_CHUNK = 16  # images per render call (synthetic.py:74-81)
N_GRASP = 16


def synthetic_ho_draws(generator: torch.Generator, n: int, n_obj: int, n_persp: int,
                       n_tex: int, n_bg: int, n_grid: int, pose_generator: PoseGenerator,
                       device) -> Dict:
    """Every random draw of one SyntheticHO init."""
    def ids(high):
        return torch.randint(0, high, (n,), generator=generator, device=device)

    return {"oid": ids(n_obj), "vid": ids(n_persp), "gid": ids(N_GRASP),
            "poses": pose_generator.draws(generator, n, device), "tex": ids(n_tex),
            "render": [render_draws(generator, min(RENDER_CHUNK, n - s), n_bg, n_grid, device)
                       for s in range(0, n, RENDER_CHUNK)]}


@DATASET.register_module
class SyntheticHO(HODataset):
    """A pre-rendered set of hand-object scenes with full annotations."""

    images_on_host = False

    def __init__(self, DATA_PRESET: Dict, device=None, draws: Optional[Dict] = None, **cfg):
        super().__init__(DATA_PRESET, device=device, **cfg)
        dev = self.device
        n = int(cfg.get("N_SAMPLES", 64))
        seed = int(cfg.get("SEED", 0))
        size = int(cfg.get("RAW_SIZE", 256))
        self.raw_size = (size, size)

        mano_model = get_mano_model(device=dev)
        obj_names = [f"synthobj_{i}" for i in range(int(cfg.get("N_OBJ", 4)))]
        obj_lib = synthetic_object_library(obj_names, seed=seed, v_max=512, f_max=1024,
                                           device=dev)
        grasp_lib = synthetic_grasp_library(len(obj_names), N_GRASP, seed=seed, device=dev)
        view_cfg = ViewEngineConfig(6, 8, 0.45, 0.55)
        scrambler = Scrambler({"TYPE": "naive", "HAND_TSL_SIGMA": 0.005,
                               "HAND_POSE_SIGMA": 0.05})
        gen_fn = PoseGenerator(mano_model, obj_lib, grasp_lib, view_cfg, scrambler,
                               build_refiner({"TYPE": "null"}, mano_model))
        assets = default_render_assets(mano_model, bg_size=int(size * 1.5), device=dev)
        if draws is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
            gy, gx = background_grid(assets.backgrounds.shape[1], assets.backgrounds.shape[2],
                                     size, size)
            draws = synthetic_ho_draws(generator, n, len(obj_names), view_cfg.n_persp,
                                       assets.hand_color_bank.shape[0],
                                       assets.backgrounds.shape[0], len(gy) * len(gx),
                                       gen_fn, dev)
        oid, vid, gid = (draws[k].to(dev) for k in ("oid", "vid", "gid"))
        gen = gen_fn(oid, vid, gid, draws["poses"])
        hand = decode_final_hand(mano_model, gen, torch.arange(n, device=dev))

        self._intr = np.array([[435.0, 0, size / 2.0], [0, 435.0, size / 2.0], [0, 0, 1]],
                              np.float32)
        intr_b = torch.from_numpy(self._intr).to(dev)[None].expand(n, 3, 3)
        verts, colors, faces, fvalid = compose_scene_arrays(
            hand["hand_verts"], assets.hand_color_bank[draws["tex"].to(dev)], assets.hand_faces,
            obj_lib.verts[oid], obj_lib.colors[oid], obj_lib.faces[oid],
            obj_lib.face_valid[oid], gen.obj_pose)
        imgs = []
        for i, s in enumerate(range(0, n, RENDER_CHUNK)):
            sl = slice(s, s + RENDER_CHUNK)
            rgb, _ = render_scene(verts[sl], colors[sl], faces[sl], fvalid[sl], intr_b[sl],
                                  assets.backgrounds, draws["render"][i], size, size)
            imgs.append(rgb)
        self.images = (torch.cat(imgs) * 255).to(torch.uint8)

        # MANO annotations in the final camera frame (cam_free folded into
        # the global rotation), so the real half carries the full schema
        pose_f, _ = rotate_hand_global(mano_model, gen.cam_free, gen.hand_pose, gen.hand_shape,
                                       gen.hand_tsl + gen.cam_offset)
        host = lambda t: t.detach().cpu().numpy()
        self._joints = host(hand["joints"])
        self._hand_pose = host(pose_f)
        self._hand_shape = host(gen.hand_shape)
        self._hand_verts = host(hand["hand_verts"])
        self._obj_pose = host(gen.obj_pose)
        self._corners_can = host(obj_lib.corners_can[oid])
        self._obj_verts_can = host(obj_lib.verts[oid])
        self._obj_id = host(oid)
        self._n = n

    def __len__(self):
        return self._n

    def get_images(self, idx: torch.Tensor) -> torch.Tensor:
        return self.images[idx.to(self.images.device)]

    def get_cam_intr(self, idx):
        return self._intr

    def get_joints_3d(self, idx):
        return self._joints[idx]

    def get_corners_3d(self, idx):
        T = self._obj_pose[idx]
        return self._corners_can[idx] @ T[:3, :3].T + T[:3, 3]

    def get_corners_can(self, idx):
        return self._corners_can[idx]

    def get_obj_verts_can(self, idx):
        return self._obj_verts_can[idx]

    def get_obj_transf(self, idx):
        return self._obj_pose[idx]

    def get_obj_idx(self, idx):
        return int(self._obj_id[idx]) + 1

    def get_hand_verts_3d(self, idx):
        return self._hand_verts[idx]

    def get_hand_pose(self, idx):
        return self._hand_pose[idx]

    def get_hand_shape(self, idx):
        return self._hand_shape[idx]


REAL_DATA_TYPES = ("HO3D", "HO3DV3", "DexYCB", "FPHB")


def missing_real_data(kind: str, cfg: Dict) -> Optional[str]:
    """The ``FileNotFoundError`` message of the JAX package's real-data
    type ``kind`` when the directory it tests is absent (``ho3d.py:95-99``,
    ``dexycb.py:104-105``, ``fhb.py:78-81``), else None."""
    root = cfg.get("DATA_ROOT", "./data")
    if kind in ("HO3D", "HO3DV3"):
        split_dir = "train" if cfg.get("DATA_SPLIT", "train") in ("train", "trainval", "val") \
            else "evaluation"
        path = os.path.join(root, "HO3D" if kind == "HO3D" else "HO3D_v3", split_dir)
        name, probe = "HO3D", path
    elif kind == "DexYCB":
        name, path = "DexYCB", os.path.join(root, "DexYCB")
        probe = path
    else:
        name, path = "FPHB", os.path.join(root, "fhbhands")
        probe = os.path.join(path, "Hand_pose_annotation_v1")
    return None if os.path.isdir(probe) else f"{name} data not found under {path}"


def build_dataset(cfg: Dict, data_preset: Dict, device=None) -> HODataset:
    """A ``DATASET.TRAIN`` / ``TEST`` node -> dataset. A real-data type
    whose data is absent raises ``FileNotFoundError`` as the JAX package's
    does (the entry point then trains synth-only or skips the test passes);
    any other type builds through the DATASET registry, which raises
    ``KeyError`` for a type it does not know."""
    kind = cfg["TYPE"]
    missing = missing_real_data(kind, cfg) if kind in REAL_DATA_TYPES else None
    if missing:
        raise FileNotFoundError(missing)
    return build_from_cfg(cfg, DATASET, {"DATA_PRESET": data_preset, "device": device})
