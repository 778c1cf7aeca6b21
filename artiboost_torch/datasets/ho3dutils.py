"""HO3D split tables and object-mesh helpers (the port's copy of
``artiboost_tpu/datasets/ho3dutils.py``; reference
``anakin/datasets/ho3dutils.py``): the v1 and v2 sequence tables, the
official train.txt / evaluation.txt frame lists, the contact distance of
the contact filter and the YCB mesh loader, which reads the port's own OBJ
parser and gives {} when the assets are absent."""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from artiboost_torch.utils.misc import logger

# sequence tables (reference ho3dutils.py:46-80, 148-226)
V2_TRAIN_SEQS = frozenset({
    "ABF10", "ABF11", "ABF12", "ABF13", "ABF14",
    "GPMF10", "GPMF11", "GPMF12", "GPMF13", "GPMF14",
    "SB10", "SB12", "SB14", "SM2", "SM3", "SM4", "SM5",
})
V2_TEST_SEQS = frozenset({
    "SM1", "MPM10", "MPM11", "MPM12", "MPM13", "MPM14",
    "SB11", "SB13", "AP10", "AP11", "AP12", "AP13", "AP14",
})
V1_TRAIN_SEQS_FILTERED = frozenset({"MC6", "MC4", "MC5", "MC1"})
V1_TRAIN_SEQS_FULL = frozenset({
    "SM5", "MC6", "MC4", "SM3", "SM4", "SS3", "SS2", "SM2", "SS1", "MC5", "MC1",
})
V1_TEST_SEQS = frozenset({"MC2"})

# sequence prefix -> grasped YCB object (reference get_seq_object)
SEQ_OBJECT_PREFIX = {
    "ABF": "021_bleach_cleanser", "BB": "011_banana", "GPMF": "010_potted_meat_can",
    "GSF": "037_scissors", "MC": "003_cracker_box", "MDF": "035_power_drill",
    "MPM": "010_potted_meat_can", "ND": "035_power_drill", "SB": "021_bleach_cleanser",
    "ShSu": "004_sugar_box", "SiBF": "011_banana", "SiS": "004_sugar_box",
    "SM": "006_mustard_bottle", "SMu": "025_mug", "SS": "004_sugar_box",
    "AP": "019_pitcher_base",
}


def get_seq_object(seq: str) -> Optional[str]:
    return SEQ_OBJECT_PREFIX.get(seq.rstrip("0123456789"))


def get_v1_seqs(split: str, filtered: bool = True) -> Tuple[frozenset, str]:
    """v1: hand-picked sequences, all under train/ (ho3dutils.py:148-186)."""
    if split == "train":
        return (V1_TRAIN_SEQS_FILTERED if filtered else V1_TRAIN_SEQS_FULL), "train"
    if split == "test":
        return V1_TEST_SEQS, "train"
    raise ValueError(f"v1 split mode supports train/test, got {split!r}")


def read_split_txt(root: str, split: str, trainval_idx: int
                   ) -> Tuple[List[Tuple[str, str]], str]:
    """The official frame list -> ([(seq, frame)], subfolder): train,
    trainval (the first ``trainval_idx`` frames) and val (the rest) read
    train.txt, test reads evaluation.txt. FileNotFoundError when absent."""
    if split in ("train", "trainval", "val"):
        info_path, subfolder = os.path.join(root, "train.txt"), "train"
    elif split == "test":
        info_path, subfolder = os.path.join(root, "evaluation.txt"), "evaluation"
    else:
        raise ValueError(f"unknown split {split!r}")
    with open(info_path) as f:
        seq_frames = [tuple(line.strip().split("/")) for line in f if line.strip()]
    if split == "trainval":
        seq_frames = seq_frames[:trainval_idx]
    elif split == "val":
        seq_frames = seq_frames[trainval_idx:]
    return seq_frames, subfolder


def get_v2_frames(root: str, split: str, trainval_idx: int = 60000,
                  keep_original_order: bool = False) -> Tuple[List[Tuple[str, str]], str]:
    """v2: the txt frames of the v2 sequences, sorted per sequence unless
    ``keep_original_order`` (ho3dutils.py:46-117)."""
    seq_frames, subfolder = read_split_txt(root, split, trainval_idx)
    known = V2_TRAIN_SEQS | V2_TEST_SEQS
    kept = [(s, f) for s, f in seq_frames if s in known]
    if keep_original_order:
        return kept, subfolder
    by_seq: Dict[str, List[str]] = {}
    for s, f in kept:
        by_seq.setdefault(s, []).append(f)
    return [(s, f) for s in by_seq for f in sorted(by_seq[s])], subfolder


def rodrigues(rvec) -> np.ndarray:
    """(3,) axis-angle -> (3, 3) float64, in ``cv2.Rodrigues``' arithmetic."""
    rx, ry, rz = (float(v) for v in np.asarray(rvec, np.float64).reshape(3))
    theta = math.sqrt(rx * rx + ry * ry + rz * rz)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1, itheta = 1.0 - c, 1.0 / theta
    rx, ry, rz = rx * itheta, ry * itheta, rz * itheta
    rrt = np.array([[rx * rx, rx * ry, rx * rz], [rx * ry, ry * ry, ry * rz],
                    [rx * rz, ry * rz, rz * rz]])
    r_x = np.array([[0.0, -rz, ry], [rz, 0.0, -rx], [-ry, rx, 0.0]])
    return c * np.eye(3) + c1 * rrt + s * r_x


def min_contact_dis(meta: Dict, obj_meshes: Dict[str, Dict[str, np.ndarray]], mano) -> float:
    """Least hand-vertex to object-vertex distance of one HO3D frame, in mm
    (ho3dutils.py:116-146), before the camera flip (an isometry). ``mano``
    is a ``NumpyMano``."""
    rot = rodrigues(meta["objRot"])
    obj = obj_meshes[meta["objName"]]["verts"] @ rot.T + np.asarray(meta["objTrans"], np.float64)
    hand_verts, _ = mano(np.asarray(meta["handPose"], np.float32),
                         np.asarray(meta["handBeta"], np.float32))
    hand = hand_verts + np.asarray(meta["handTrans"], np.float32)
    d2 = np.sum(hand * hand, -1)[:, None] + np.sum(obj * obj, -1)[None] - 2.0 * hand @ obj.T
    return float(np.sqrt(max(d2.min(), 0.0)) * 1000.0)


def load_ycb_obj_meshes(models_root: str, mesh_name: str = "textured_simple_ds.obj"
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """{name: {"verts": (V, 3) f32, "faces": (F, 3) i32}} of a YCB models
    folder (``mesh_name``, else the folder's first .obj); {} when absent."""
    if not os.path.isdir(models_root):
        return {}
    from artiboost_torch.artiboost.object_library import load_obj_file

    out = {}
    for name in sorted(os.listdir(models_root)):
        path = os.path.join(models_root, name, mesh_name)
        if not os.path.isfile(path):
            folder = os.path.join(models_root, name)
            objs = sorted(f for f in os.listdir(folder) if f.endswith(".obj")) \
                if os.path.isdir(folder) else []
            if not objs:
                continue
            path = os.path.join(folder, objs[0])
        verts, faces, _ = load_obj_file(path)
        out[name] = {"verts": np.asarray(verts, np.float32), "faces": np.asarray(faces, np.int32)}
    if out:
        logger.info(f"loaded {len(out)} YCB object meshes from {models_root}")
    return out
