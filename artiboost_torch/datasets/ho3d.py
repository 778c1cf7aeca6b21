"""HO3D v2 / v3 loaders (counterpart of ``artiboost_tpu/datasets/ho3d.py``;
reference ``anakin/datasets/ho3d.py``).

The official release layout::

    {DATA_ROOT}/HO3D{,_v3}/{train|evaluation}/{seq}/meta/{frame}.pkl
                                        .../rgb/{frame}.{png|jpg}
    {DATA_ROOT}/HO3D{,_v3}/train.txt, evaluation.txt

Split modes: ``paper`` (the official frame lists, trainval cut at 6,000
frames), ``v1`` (hand-picked sequences under train/) and ``v2`` (the txt
frames of the v2 sequence tables). Without the txt files the frame list
falls back to a directory sweep with the paper-val heuristic, and a
warning says so. The sample list is cached per (version, split, mode, mini
factor, contact filter) under ``common/cache/ho3d_torch_<md5>.npz``, a
name of the port's own, so a cache the JAX package wrote is never read.
Annotations get HO3D's OpenGL flip (y and z negated) on access, and
``handJoints3D`` is reordered into the 21-keypoint MANO convention; the
MANO accessors run ``NumpyMano`` on the host."""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from artiboost_torch.datasets import ho3dutils
from artiboost_torch.datasets.hodata import HODataset, decode_rgb
from artiboost_torch.mano.model import JOINT_REORDER, get_mano_model
from artiboost_torch.mano.numpy_fk import NumpyMano, aa_to_rotmat_np, rotmat_to_aa_np
from artiboost_torch.utils.misc import CONST, logger
from artiboost_torch.utils.registry import DATASET

_CAM_EXTR = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
# the validation sequences of the directory sweep when train.txt is absent
_PAPER_VAL_SEQS = ("SM1", "MC2")
_REORDER = np.asarray(JOINT_REORDER, np.int64)


@DATASET.register_module
class HO3D(HODataset):
    version = "v2"

    def __init__(self, DATA_PRESET: Dict, device=None, **cfg):
        super().__init__(DATA_PRESET, device=device, **cfg)
        self.name = f"HO3D_{self.version}"
        self.split_mode = cfg.get("SPLIT_MODE", "paper")
        self.raw_size = (640, 480)
        self.rgb_ext = ".png" if self.version == "v2" else ".jpg"
        self.root = os.path.join(self.data_root, "HO3D" if self.version == "v2" else "HO3D_v3")
        self.samples: List[Dict] = []
        self._mano: Optional[NumpyMano] = None
        self._obj_meshes: Optional[Dict] = None
        self._verts_can_cache: Dict[str, np.ndarray] = {}
        self._load_annotations()

    @property
    def mano(self) -> NumpyMano:
        if self._mano is None:
            self._mano = NumpyMano(get_mano_model(device="cpu"))
        return self._mano

    @property
    def obj_meshes(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The YCB meshes of ``{DATA_ROOT}/YCB_models_supp``; {} when absent."""
        if self._obj_meshes is None:
            self._obj_meshes = ho3dutils.load_ycb_obj_meshes(
                os.path.join(self.data_root, "YCB_models_supp"))
        return self._obj_meshes

    def _dir_sweep_frames(self):
        """The frame list from the directory listing (no train.txt)."""
        split_dir = "train" if self.data_split in ("train", "trainval", "val") else "evaluation"
        base = os.path.join(self.root, split_dir)
        if not os.path.isdir(base):
            raise FileNotFoundError(f"HO3D data not found under {base}")
        seqs = sorted(os.listdir(base))
        if split_dir == "train":
            if self.data_split == "val":
                seqs = [s for s in seqs if s in _PAPER_VAL_SEQS]
            elif self.data_split == "train" and self.split_mode == "paper":
                seqs = [s for s in seqs if s not in _PAPER_VAL_SEQS]
            if self.split_mode == "v2":
                known = ho3dutils.V2_TRAIN_SEQS if self.data_split != "test" \
                    else ho3dutils.V2_TEST_SEQS
                seqs = [s for s in seqs if s in known]
        out = []
        for seq in seqs:
            meta_dir = os.path.join(base, seq, "meta")
            if os.path.isdir(meta_dir):
                out += [(seq, os.path.splitext(f)[0]) for f in sorted(os.listdir(meta_dir))]
        return out, split_dir

    def _seq_frames(self):
        """(seq, frame) list of the split mode (reference :78-96)."""
        if self.split_mode == "v1":
            seqs, subfolder = ho3dutils.get_v1_seqs(self.data_split)
            out = []
            for seq in sorted(seqs):
                meta_dir = os.path.join(self.root, subfolder, seq, "meta")
                if os.path.isdir(meta_dir):
                    out += [(seq, os.path.splitext(f)[0]) for f in sorted(os.listdir(meta_dir))]
            return out, subfolder
        try:
            if self.split_mode == "paper":
                return ho3dutils.read_split_txt(self.root, self.data_split, trainval_idx=6000)
            if self.split_mode == "v2":
                # the v2 tables index HO3D (v2)'s txt files in both versions
                return ho3dutils.get_v2_frames(
                    os.path.join(self.data_root, "HO3D"), self.data_split, trainval_idx=60000,
                    keep_original_order=(self.data_split == "test"))
        except FileNotFoundError:
            logger.warning(f"{self.name}: official split txt missing under {self.root}; "
                           "falling back to directory sweep")
            return self._dir_sweep_frames()
        raise NotImplementedError(f"unknown split mode {self.split_mode!r}")

    def _cache_path(self):
        ident = hashlib.md5(
            f"{self.version}_{self.data_split}_{self.split_mode}_{self.mini_factor}_"
            f"{self.filter_no_contact}_{self.filter_thresh}".encode()).hexdigest()[:10]
        return os.path.join("common", "cache", f"ho3d_torch_{ident}.npz")

    def _load_annotations(self):
        cache = self._cache_path()
        if self.use_cache and os.path.isfile(cache):
            self.samples = list(np.load(cache, allow_pickle=True)["samples"])
            logger.info(f"{self.name}: {len(self.samples)} samples (cached)")
            return
        seq_frames, subfolder = self._seq_frames()
        base = os.path.join(self.root, subfolder)
        contact_filter = self.filter_no_contact and self.filter_thresh > 0
        if contact_filter and not self.obj_meshes:
            logger.warning(f"{self.name}: FILTER_NO_CONTACT requested but no YCB meshes "
                           "found — filter disabled")
            contact_filter = False
        n_filtered = 0
        for seq, frame in seq_frames:
            meta_path = os.path.join(base, seq, "meta", frame + ".pkl")
            if not os.path.isfile(meta_path):
                continue
            with open(meta_path, "rb") as f:
                meta = pickle.load(f)
            if meta.get("handJoints3D") is None:
                continue
            # the evaluation split ships only the wrist (reference :170-175)
            if np.asarray(meta["handJoints3D"]).size == 3:
                root = np.asarray(meta["handJoints3D"], np.float32).reshape(3)
                meta["handTrans"] = root
                meta["handJoints3D"] = np.tile(root[None], (CONST.NUM_JOINTS, 1))
                meta["handPose"] = np.zeros(48, np.float32)
                meta["handBeta"] = np.zeros(10, np.float32)
            if (contact_filter and "handPose" in meta and meta["objName"] in self.obj_meshes
                    and ho3dutils.min_contact_dis(meta, self.obj_meshes, self.mano)
                    > self.filter_thresh):
                n_filtered += 1
                continue
            self.samples.append({"img": os.path.join(base, seq, "rgb", frame + self.rgb_ext),
                                 "meta": meta, "seq": seq})
        if n_filtered:
            logger.info(f"{self.name}: contact filter dropped {n_filtered} frames "
                        f"(> {self.filter_thresh} mm)")
        if self.mini_factor < 1.0:
            self.samples = self.samples[::int(1.0 / self.mini_factor)]
        if self.use_cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.savez_compressed(cache, samples=np.asarray(self.samples, dtype=object))
        logger.info(f"{self.name}: {len(self.samples)} samples")

    def __len__(self):
        return len(self.samples)

    def get_image(self, idx):
        return decode_rgb(self.samples[idx]["img"])

    def get_cam_intr(self, idx):
        return np.asarray(self.samples[idx]["meta"]["camMat"], np.float32)

    def get_joints_3d(self, idx):
        j = np.asarray(self.samples[idx]["meta"]["handJoints3D"], np.float32)
        j = np.tile(j[None], (CONST.NUM_JOINTS, 1)) if j.ndim == 1 else j[_REORDER]
        return j @ _CAM_EXTR.T

    def get_corners_3d(self, idx):
        return np.asarray(self.samples[idx]["meta"]["objCorners3D"], np.float32) @ _CAM_EXTR.T

    def _can_offset(self, idx) -> np.ndarray:
        """Bbox centre of the object model in its raw (unflipped) frame, the
        origin of the canonical frame: from the YCB mesh when on disk, else
        from the rest corners."""
        meta = self.samples[idx]["meta"]
        mesh = self.obj_meshes.get(meta["objName"])
        v = mesh["verts"] if mesh is not None else np.asarray(meta["objCorners3DRest"],
                                                                np.float32)
        return (v.min(0) + v.max(0)) / 2.0

    def get_corners_can(self, idx):
        meta = self.samples[idx]["meta"]
        return np.asarray(meta["objCorners3DRest"], np.float32) - self._can_offset(idx)

    def get_obj_transf(self, idx):
        """Canonical frame -> camera: the bbox-centre offset folds into the
        translation (reference ho3d.py:440-463)."""
        meta = self.samples[idx]["meta"]
        rot = ho3dutils.rodrigues(meta["objRot"]).astype(np.float32)
        tsl = np.asarray(meta["objTrans"], np.float32)
        offset = self._can_offset(idx).astype(np.float32)
        transf = np.eye(4, dtype=np.float32)
        transf[:3, :3] = _CAM_EXTR @ rot
        transf[:3, 3] = _CAM_EXTR @ (rot @ offset + tsl)
        return transf

    def get_obj_idx(self, idx):
        return CONST.YCB_CLASSES2IDX.get(self.samples[idx]["meta"]["objName"], 0)

    def get_obj_verts_can(self, idx):
        """Bbox-centred object vertices in the raw model frame; None when
        the YCB meshes are absent."""
        name = self.samples[idx]["meta"]["objName"]
        if name not in self._verts_can_cache:
            mesh = self.obj_meshes.get(name)
            if mesh is None:
                return None
            verts = mesh["verts"]
            self._verts_can_cache[name] = (verts - (verts.min(0) + verts.max(0)) / 2.0
                                           ).astype(np.float32)
        return self._verts_can_cache[name]

    def _hand_info(self, idx):
        meta = self.samples[idx]["meta"]
        return (np.asarray(meta["handPose"], np.float32).reshape(-1),
                np.asarray(meta["handTrans"], np.float32).reshape(3),
                np.asarray(meta["handBeta"], np.float32).reshape(-1))

    def _has_mano(self, idx) -> bool:
        meta = self.samples[idx]["meta"]
        return "handPose" in meta and "handBeta" in meta and "handTrans" in meta

    def get_hand_pose(self, idx):
        """(48,) axis-angle wrt the camera: the flip folds into the global
        segment (reference :523-531)."""
        if not self._has_mano(idx):
            return None
        pose = self._hand_info(idx)[0]
        root = rotmat_to_aa_np(_CAM_EXTR @ aa_to_rotmat_np(pose[:3]))
        return np.concatenate([root, pose[3:]]).astype(np.float32)

    def get_hand_shape(self, idx):
        return self._hand_info(idx)[2] if self._has_mano(idx) else None

    def get_hand_verts_3d(self, idx):
        """FK vertices plus handTrans, flipped (reference :253-262)."""
        if not self._has_mano(idx):
            return None
        pose, tsl, shape = self._hand_info(idx)
        verts, _ = self.mano(pose, shape)
        return ((verts + tsl) @ _CAM_EXTR.T).astype(np.float32)

    def get_sides(self, idx):
        return "right"


@DATASET.register_module
class HO3DV3(HO3D):
    version = "v3"
