"""DexYCB loader (counterpart of ``artiboost_tpu/datasets/dexycb.py``;
reference ``anakin/datasets/dexycb.py`` over the dex-ycb-toolkit), reading
the official release directly::

    {DATA_ROOT}/DexYCB/{subject}/{scene}/meta.yml
                        .../{camera}/labels_{frame}.npz, color_{frame}.jpg
    {DATA_ROOT}/DexYCB/calibration/intrinsics/{camera}_640x480.yml
                        .../mano_{calib}/mano.yml
    {DATA_ROOT}/DexYCB/models/{ycb name}/textured_simple.obj

Subjects, a subject's scenes and a scene's cameras are taken in sorted
order; the split modes are the toolkit's s0-s3 (``_SPLITS``). Samples are
filtered to visible (and, with ``FILTER_NO_CONTACT``, in-contact) right
hands, and the sample list is cached under
``common/cache/dexycb_torch_<md5>.npz``, a name of the port's own. MANO
vertices: PCA-45 FK with ``flat_hand_mean`` off of ``pose_m[:48]`` plus the
``pose_m[48:]`` translation, betas from the subject's calibration."""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np
import yaml

from artiboost_torch.datasets.hodata import HODataset, decode_rgb
from artiboost_torch.mano.model import get_mano_model
from artiboost_torch.mano.numpy_fk import NumpyMano
from artiboost_torch.utils.misc import CONST, logger
from artiboost_torch.utils.registry import DATASET

# (subject indices, serial indices, sequence predicate) per (setup, split); None keeps all
_SPLITS = {
    ("s0", "train"): (None, None, lambda i: i % 5 != 4),
    ("s0", "val"): ({0, 1}, None, lambda i: i % 5 == 4),
    ("s0", "test"): (set(range(2, 10)), None, lambda i: i % 5 == 4),
    ("s1", "train"): ({0, 1, 2, 3, 4, 5, 9}, None, None),
    ("s1", "val"): ({6}, None, None),
    ("s1", "test"): ({7, 8}, None, None),
    ("s2", "train"): (None, set(range(6)), None),
    ("s2", "val"): (None, {6}, None),
    ("s2", "test"): (None, {7}, None),
    ("s3", "train"): (None, None, lambda i: i // 5 not in (3, 7, 11, 15, 19)),
    ("s3", "val"): (None, None, lambda i: i // 5 in (3, 19)),
    ("s3", "test"): (None, None, lambda i: i // 5 in (7, 11, 15)),
}


def _box_corners(verts: np.ndarray) -> np.ndarray:
    lo, hi = verts.min(0), verts.max(0)
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])], np.float32) - (lo + hi) / 2


@DATASET.register_module
class DexYCB(HODataset):
    def __init__(self, DATA_PRESET: Dict, device=None, **cfg):
        super().__init__(DATA_PRESET, device=device, **cfg)
        self.name = "DexYCB"
        self.split_mode = cfg.get("SPLIT_MODE", "s0")
        self.use_left_hand = bool(cfg.get("USE_LEFT_HAND", False))
        self.filter_invisible_hand = bool(cfg.get("FILTER_INVISIBLE_HAND", True))
        self.raw_size = (640, 480)
        self.root = os.path.join(self.data_root, "DexYCB")
        self.samples: List[Dict] = []
        self._mano: Optional[NumpyMano] = None
        self._betas_cache: Dict[str, np.ndarray] = {}
        self._intr_cache: Dict[str, np.ndarray] = {}
        self._verts_cache: Dict[int, Optional[np.ndarray]] = {}
        self._corner_cache: Dict[int, np.ndarray] = {}
        self._load_annotations()

    @property
    def mano(self) -> NumpyMano:
        if self._mano is None:
            self._mano = NumpyMano(get_mano_model(device="cpu"), use_pca=True, ncomps=45,
                                   flat_hand_mean=False)
        return self._mano

    def _load_annotations(self):
        if (self.split_mode, self.data_split) not in _SPLITS:
            raise ValueError(f"unknown DexYCB split {self.split_mode}/{self.data_split}")
        subj_keep, serial_keep, seq_pred = _SPLITS[self.split_mode, self.data_split]
        ident = hashlib.md5(
            f"dexycb_{self.split_mode}_{self.data_split}_{self.mini_factor}_"
            f"{self.filter_no_contact}_{self.filter_thresh}".encode()).hexdigest()[:10]
        cache = os.path.join("common", "cache", f"dexycb_torch_{ident}.npz")
        if self.use_cache and os.path.isfile(cache):
            self.samples = list(np.load(cache, allow_pickle=True)["samples"])
            logger.info(f"{self.name}: {len(self.samples)} samples (cached)")
            return
        if not os.path.isdir(self.root):
            raise FileNotFoundError(f"DexYCB data not found under {self.root}")
        subjects = sorted(d for d in os.listdir(self.root) if d.startswith("2020"))
        for subj_idx, subj in enumerate(subjects):
            if subj_keep is not None and subj_idx not in subj_keep:
                continue
            subj_dir = os.path.join(self.root, subj)
            scenes = sorted(s for s in os.listdir(subj_dir)
                            if os.path.isdir(os.path.join(subj_dir, s)))
            for seq_idx, scene in enumerate(scenes):
                if seq_pred is not None and not seq_pred(seq_idx):
                    continue
                scene_dir = os.path.join(subj_dir, scene)
                meta_path = os.path.join(scene_dir, "meta.yml")
                if not os.path.isfile(meta_path):
                    continue
                with open(meta_path) as f:
                    meta = yaml.safe_load(f)
                side = meta.get("mano_sides", ["right"])[0]
                if not self.use_left_hand and side != "right":
                    continue
                for serial_idx, cam in enumerate(sorted(meta.get("serials", []))):
                    if serial_keep is not None and serial_idx not in serial_keep:
                        continue
                    cam_dir = os.path.join(scene_dir, cam)
                    if not os.path.isdir(cam_dir):
                        continue
                    for fname in sorted(os.listdir(cam_dir)):
                        if fname.startswith("labels_") and fname.endswith(".npz"):
                            frame = fname[len("labels_"):-len(".npz")]
                            self.samples.append({
                                "labels": os.path.join(cam_dir, fname),
                                "img": os.path.join(cam_dir, f"color_{frame}.jpg"),
                                "ycb_grasp_ind": meta.get("ycb_grasp_ind", 0),
                                "ycb_ids": meta.get("ycb_ids", [1]),
                                "cam": cam,
                                "mano_calib": (meta.get("mano_calib") or [None])[0],
                                "side": side,
                            })
        self._filter_samples()
        if self.mini_factor < 1.0:
            self.samples = self.samples[::int(1.0 / self.mini_factor)]
        if self.use_cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.savez_compressed(cache, samples=np.asarray(self.samples, dtype=object))
        logger.info(f"{self.name}: {len(self.samples)} samples")

    def _filter_samples(self):
        """Drop frames whose hand is invisible (every joint -1) and, with
        the contact filter, those whose hand joints stay farther than
        FILTER_THRESH mm from the object's vertices (its box corners when
        the models are absent) (reference dexycb.py:83-105)."""
        if not (self.filter_invisible_hand or self.filter_no_contact):
            return
        keep = []
        for i, s in enumerate(self.samples):
            lab = np.load(s["labels"])
            j3d = np.asarray(lab["joint_3d"], np.float32).reshape(21, 3)
            if self.filter_invisible_hand and np.all(j3d == -1):
                continue
            if self.filter_no_contact and self.filter_thresh > 0:
                pose = np.asarray(lab["pose_y"], np.float32)[s["ycb_grasp_ind"]]
                can = self._obj_pts_for_contact(int(s["ycb_ids"][s["ycb_grasp_ind"]]))
                pts = can @ pose[:3, :3].T + pose[:3, 3]
                if np.linalg.norm(j3d[:, None] - pts[None], axis=-1).min() * 1000.0 \
                        > self.filter_thresh:
                    continue
            keep.append(i)
        dropped = len(self.samples) - len(keep)
        if dropped:
            logger.info(f"{self.name}: contact/visibility filter dropped "
                        f"{dropped}/{len(self.samples)} frames")
        self.samples = [self.samples[i] for i in keep]

    def _labels(self, idx):
        return np.load(self.samples[idx]["labels"])

    def __len__(self):
        return len(self.samples)

    def get_image(self, idx):
        return decode_rgb(self.samples[idx]["img"])

    def get_cam_intr(self, idx):
        """The camera's colour intrinsics from the calibration files
        (reference dexycb.py:191-205), cached per camera."""
        cam = self.samples[idx]["cam"]
        if cam not in self._intr_cache:
            with open(os.path.join(self.root, "calibration",
                                   f"intrinsics/{cam}_640x480.yml")) as f:
                y = yaml.safe_load(f)["color"]
            self._intr_cache[cam] = np.array(
                [[y["fx"], 0, y["ppx"]], [0, y["fy"], y["ppy"]], [0, 0, 1]], np.float32)
        return self._intr_cache[cam]

    def get_joints_3d(self, idx):
        return np.asarray(self._labels(idx)["joint_3d"], np.float32).reshape(21, 3)

    def get_corners_3d(self, idx):
        transf = self.get_obj_transf(idx)
        return self.get_corners_can(idx) @ transf[:3, :3].T + transf[:3, 3]

    def _obj_verts_for_obj(self, obj_idx) -> Optional[np.ndarray]:
        """Raw ``textured_simple.obj`` vertices of a YCB object, or None."""
        if obj_idx not in self._verts_cache:
            path = os.path.join(self.root, "models", CONST.YCB_IDX2CLASSES[obj_idx],
                                "textured_simple.obj")
            verts = None
            if os.path.isfile(path):
                from artiboost_torch.artiboost.object_library import load_obj_file

                verts = np.asarray(load_obj_file(path)[0], np.float32)
            self._verts_cache[obj_idx] = verts
        return self._verts_cache[obj_idx]

    def _obj_pts_for_contact(self, obj_idx) -> np.ndarray:
        verts = self._obj_verts_for_obj(obj_idx)
        return verts if verts is not None else self._corners_can_for_obj(obj_idx)

    def _corners_can_for_obj(self, obj_idx):
        if obj_idx not in self._corner_cache:
            verts = self._obj_verts_for_obj(obj_idx)
            if verts is None:
                raise FileNotFoundError(f"YCB model for object {obj_idx} not found under "
                                        f"{os.path.join(self.root, 'models')}")
            self._corner_cache[obj_idx] = _box_corners(verts)
        return self._corner_cache[obj_idx]

    def get_corners_can(self, idx):
        return self._corners_can_for_obj(self.get_obj_idx(idx))

    def get_obj_verts_can(self, idx):
        verts = self._obj_verts_for_obj(self.get_obj_idx(idx))
        if verts is None:
            return None
        return (verts - (verts.min(0) + verts.max(0)) / 2.0).astype(np.float32)

    def get_obj_transf(self, idx):
        """Canonical (bbox-centred) frame -> camera; the centre offset folds
        into the translation, zero when the models are absent (reference
        dexycb.py:257-269)."""
        s = self.samples[idx]
        pose = np.asarray(self._labels(idx)["pose_y"], np.float32)[s["ycb_grasp_ind"]]
        verts = self._obj_verts_for_obj(self.get_obj_idx(idx))
        offset = np.zeros(3, np.float32) if verts is None else \
            ((verts.min(0) + verts.max(0)) / 2.0).astype(np.float32)
        transf = np.eye(4, dtype=np.float32)
        transf[:3, :3] = pose[:3, :3]
        transf[:3, 3] = pose[:3, :3] @ offset + pose[:3, 3]
        return transf

    def get_obj_idx(self, idx):
        s = self.samples[idx]
        return int(s["ycb_ids"][s["ycb_grasp_ind"]])

    def _mano_betas(self, idx) -> np.ndarray:
        calib = self.samples[idx].get("mano_calib")
        if calib is None:
            return np.zeros(10, np.float32)
        if calib not in self._betas_cache:
            path = os.path.join(self.root, "calibration", f"mano_{calib}", "mano.yml")
            betas = np.zeros(10, np.float32)
            if os.path.isfile(path):
                with open(path) as f:
                    betas = np.asarray(yaml.safe_load(f)["betas"], np.float32)
            self._betas_cache[calib] = betas
        return self._betas_cache[calib]

    def _pose_m(self, idx) -> Optional[np.ndarray]:
        if self.samples[idx].get("side", "right") != "right":
            return None  # a left hand's FK needs the left MANO model
        lab = self._labels(idx)
        if "pose_m" not in lab.files:
            return None
        return np.asarray(lab["pose_m"], np.float32).reshape(-1)

    def get_hand_shape(self, idx):
        return None if self._pose_m(idx) is None else self._mano_betas(idx)

    def get_hand_pose(self, idx):
        """(48,) full axis-angle decoded from the PCA-45 label pose."""
        pose_m = self._pose_m(idx)
        return None if pose_m is None else self.mano.full_pose(pose_m[:48])

    def get_hand_verts_3d(self, idx):
        pose_m = self._pose_m(idx)
        if pose_m is None:
            return None
        verts, _ = self.mano(pose_m[:48], self._mano_betas(idx))
        return (verts + pose_m[48:]).astype(np.float32)

    def get_sides(self, idx):
        return self.samples[idx].get("side", "right")
