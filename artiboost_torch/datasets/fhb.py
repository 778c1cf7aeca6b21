"""First-Person Hand Benchmark (FPHB / FHAB) loader (counterpart of
``artiboost_tpu/datasets/fhb.py``; reference ``anakin/datasets/fhb.py``).

Reads the official release: per-sequence ``skeleton.txt`` poses and the
object 6D annotations of the juice / milk / liquid-soap / salt subset. The
1920x1080 frames are shrunk by ``REDUCE_FACTOR`` (reference :241) with
``resize_linear``, the port's copy of OpenCV's bilinear ``cv2.resize``."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from artiboost_torch.datasets.hodata import HODataset, decode_rgb
from artiboost_torch.utils.misc import logger
from artiboost_torch.utils.registry import DATASET

# FPHA skeleton order -> the 21-keypoint convention (reference fhb reorder)
_REORDER_IDX = [0, 1, 6, 7, 8, 2, 9, 10, 11, 3, 12, 13, 14, 4, 15, 16, 17, 5, 18, 19, 20]
_CAM_INTR = np.array([[1395.749023, 0, 935.732544],
                      [0, 1395.749268, 540.681030],
                      [0, 0, 1]], np.float32)
_CAM_EXTR = np.array([
    [0.999988496304, -0.00468848412856, 0.000982563360594, 25.7],
    [0.00469115935266, 0.999985218048, -0.00273845880292, 1.22],
    [-0.000969709653873, 0.00274303671904, 0.99999576807, 3.902],
    [0, 0, 0, 1],
], np.float32)
_OBJECTS = ("juice_bottle", "liquid_soap", "milk", "salt")


def _linear_taps(n_src: int, n_dst: int):
    """Source indices and 11-bit weights of OpenCV's bilinear resize along
    one axis (half-pixel centres, edges clamped)."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    clamp = (s < 0) | (s >= n_src - 1)
    f[clamp] = 0
    s = np.clip(s, 0, n_src - 1)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return s, np.minimum(s + 1, n_src - 1), w0, w1


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """(h, w, C) uint8 -> (H, W, C) for ``size`` = (W, H), in the fixed-point
    arithmetic of ``cv2.resize``'s INTER_LINEAR: an exact halving averages
    2x2 blocks (OpenCV takes its area path there); otherwise 11-bit weights
    per axis, the horizontal pass in integers, the vertical one rounded as
    OpenCV's ``VResizeLinear`` rounds. Bit-equal to OpenCV at the halving
    of the release's frames; elsewhere within one level on under 1 % of the
    values (``tests/test_torch_fhb.py``)."""
    W, H = size
    h, w = img.shape[:2]
    src = img.astype(np.int64)
    if w == 2 * W and h == 2 * H:
        out = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2] + 2) >> 2
        return out.astype(np.uint8)
    xs0, xs1, a0, a1 = _linear_taps(w, W)
    ys0, ys1, b0, b1 = _linear_taps(h, H)
    rows = src[:, xs0] * a0[None, :, None] + src[:, xs1] * a1[None, :, None]
    out = (((b0[:, None, None] * (rows[ys0] >> 4)) >> 16)
           + ((b1[:, None, None] * (rows[ys1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


@DATASET.register_module
class FPHB(HODataset):
    def __init__(self, DATA_PRESET: Dict, device=None, **cfg):
        super().__init__(DATA_PRESET, device=device, **cfg)
        self.name = "FPHB"
        self.split_mode = cfg.get("SPLIT_MODE", "subjects")
        self.reduce_factor = float(cfg.get("REDUCE_FACTOR", 0.5))
        self.raw_size = (int(1920 * self.reduce_factor), int(1080 * self.reduce_factor))
        self.root = os.path.join(self.data_root, "fhbhands")
        self.samples: List[Dict] = []
        self._corner_cache: Dict[str, np.ndarray] = {}
        self._load_annotations()

    def _action_split_seqs(self):
        """The (subject, action, seq) of this split from the official
        ``data_split_action_recognition.txt`` (reference fhbutils.py:244-256)."""
        path = os.path.join(self.root, "data_split_action_recognition.txt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"actions split file missing: {path}")
        want_test = self.data_split in ("test", "val")
        keep, in_test = set(), False
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                head = line.split(" ")[0].lower()
                if head.startswith("train"):
                    in_test = False
                    continue
                if head.startswith("test"):
                    in_test = True
                    continue
                if in_test == want_test or self.data_split == "all":
                    parts = line.split(" ")[0].split("/")
                    if len(parts) == 3:
                        keep.add(tuple(parts))
        return keep

    def _load_annotations(self):
        skel_root = os.path.join(self.root, "Hand_pose_annotation_v1")
        obj_root = os.path.join(self.root, "Object_6D_pose_annotation_v1_1")
        if not os.path.isdir(skel_root):
            raise FileNotFoundError(f"FPHB data not found under {self.root}")
        if self.split_mode == "actions":
            action_keep = self._action_split_seqs()
            subjects = sorted({s for s, _, _ in action_keep})
        else:  # "subjects"
            action_keep = None
            subjects = [f"Subject_{i}" for i in ((1, 3, 4) if self.data_split == "train"
                                                 else (2, 5, 6))]
        for subj in subjects:
            subj_obj = os.path.join(obj_root, subj)
            if not os.path.isdir(subj_obj):
                continue
            for action in sorted(os.listdir(subj_obj)):
                obj_name = next((o for o in _OBJECTS if o in action), None)
                if obj_name is None:
                    continue
                for seq in sorted(os.listdir(os.path.join(subj_obj, action))):
                    if action_keep is not None and (subj, action, seq) not in action_keep:
                        continue
                    pose_file = os.path.join(subj_obj, action, seq, "object_pose.txt")
                    skel_file = os.path.join(skel_root, subj, action, seq, "skeleton.txt")
                    if not (os.path.isfile(pose_file) and os.path.isfile(skel_file)):
                        continue
                    skel = np.loadtxt(skel_file)
                    obj_poses = np.loadtxt(pose_file)
                    for fi in range(min(skel.shape[0], obj_poses.shape[0])):
                        self.samples.append({
                            "img": os.path.join(self.root, "Video_files", subj, action, seq,
                                                "color", f"color_{fi:04d}.jpeg"),
                            "skel": skel[fi, 1:].reshape(21, 3),
                            "obj_pose": obj_poses[fi, 1:].reshape(4, 4).T,
                            "obj_name": obj_name,
                        })
        if self.mini_factor < 1.0:
            self.samples = self.samples[::int(1.0 / self.mini_factor)]
        logger.info(f"{self.name}: {len(self.samples)} samples")

    def __len__(self):
        return len(self.samples)

    def get_image(self, idx):
        return resize_linear(decode_rgb(self.samples[idx]["img"]), self.raw_size)

    def get_cam_intr(self, idx):
        K = _CAM_INTR.copy()
        K[:2] *= self.reduce_factor
        return K

    def get_joints_3d(self, idx):
        skel_mm = self.samples[idx]["skel"][_REORDER_IDX]  # world frame, mm
        hom = np.concatenate([skel_mm, np.ones((21, 1))], 1)
        return ((_CAM_EXTR @ hom.T).T[:, :3] / 1000.0).astype(np.float32)

    def get_corners_3d(self, idx):
        transf = self.get_obj_transf(idx)
        return self.get_corners_can(idx) @ transf[:3, :3].T + transf[:3, 3]

    def get_corners_can(self, idx):
        """Box corners of the object's model (its ``.obj`` beside the
        release's ``.ply``), or of a fixed 8 x 12 x 8 cm box without it."""
        name = self.samples[idx]["obj_name"]
        if name not in self._corner_cache:
            path = os.path.join(self.root, "Object_models", f"{name}_model", f"{name}_model.obj")
            if os.path.isfile(path):
                from artiboost_torch.artiboost.object_library import load_obj_file

                verts = load_obj_file(path)[0]
            else:
                verts = np.array([[x, y, z] for x in (-0.04, 0.04) for y in (-0.06, 0.06)
                                  for z in (-0.04, 0.04)], np.float32)
            lo, hi = verts.min(0), verts.max(0)
            self._corner_cache[name] = np.array(
                [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                 for z in (lo[2], hi[2])], np.float32) - (lo + hi) / 2
        return self._corner_cache[name]

    def get_obj_transf(self, idx):
        out = (_CAM_EXTR @ self.samples[idx]["obj_pose"].astype(np.float32)).astype(np.float32)
        out[:3, 3] /= 1000.0
        return out

    def get_obj_idx(self, idx):
        return _OBJECTS.index(self.samples[idx]["obj_name"]) + 1
