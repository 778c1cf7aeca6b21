"""Writers of the official on-disk layouts with seeded content: HO3D's
split folders and frame lists, DexYCB's subject/scene/camera folders with
their calibration and object meshes, the YCB meshes with their MTL and texture,
the pickled grasps, the background pool, the HTML textured hands and a
torchvision-named ImageNet ResNet. The CPU tests write them small and feed
them to both packages; ``chip_smoke.py`` writes them at the sizes of the
released data and trains on them. Every image is textured (a smooth
pattern under per-pixel noise), so decoding costs what a photograph's
does, not what a flat image's does."""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

HO3D_CAM = np.array([[617.343, 0.0, 312.42], [0.0, 617.343, 241.42], [0.0, 0.0, 1.0]])


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


def _save_image(path: str, img: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".png"):
        Image.fromarray(img).save(path, compress_level=1)
    else:
        Image.fromarray(img).save(path, quality=90)


def ho3d_meta(rng: np.random.RandomState, obj_name: str, with_mano: bool,
              wrist_only: bool = False) -> Dict:
    """One frame's annotation pickle in HO3D's convention (OpenGL frame:
    the hand half a metre down -z)."""
    joints = (rng.randn(21, 3) * 0.03 + [0.0, 0.0, -0.5]).astype(np.float32)
    rest = (rng.randn(8, 3) * 0.04).astype(np.float32)
    meta = {"camMat": HO3D_CAM.copy(),
            "handJoints3D": joints[0] if wrist_only else joints,
            "objCorners3D": (rest + [0.03, 0.0, -0.5]).astype(np.float32),
            "objCorners3DRest": rest,
            "objRot": (rng.randn(3) * 0.3).astype(np.float32),
            "objTrans": np.array([0.03, 0.0, -0.5], np.float32) + (
                rng.randn(3) * 0.01).astype(np.float32),
            "objName": obj_name}
    if with_mano and not wrist_only:
        meta["handPose"] = (rng.randn(48) * 0.1).astype(np.float32)
        meta["handBeta"] = (rng.randn(10) * 0.3).astype(np.float32)
        meta["handTrans"] = joints[0].copy()
    return meta


def write_ho3d(data_root: str, split: str, seqs: Dict[str, int], objects: Sequence[str],
               rng: np.random.RandomState, version: str = "v2", size: Tuple[int, int] = (640, 480),
               with_mano: bool = True, n_images: Optional[int] = None) -> int:
    """``{data_root}/HO3D{,_v3}/{train|evaluation}/<seq>/{meta/*.pkl, rgb/*}``
    for ``seqs`` ({name: frames}), each sequence grasping
    ``objects[i % len]``, and the frames appended to ``train.txt`` or
    ``evaluation.txt``; evaluation metas hold the wrist alone, as the
    release's do. ``n_images`` distinct images are drawn and shifted per
    frame (all distinct when None). -> frames written."""
    root = os.path.join(data_root, "HO3D" if version == "v2" else "HO3D_v3")
    sub = "train" if split == "train" else "evaluation"
    ext = ".png" if version == "v2" else ".jpg"
    w, h = size
    bank = [textured_image(rng, h, w) for _ in range(n_images)] if n_images else None
    lines, images = [], []
    for i, (seq, frames) in enumerate(seqs.items()):
        for f in range(frames):
            meta = ho3d_meta(rng, objects[i % len(objects)], with_mano, wrist_only=(sub != "train"))
            meta_path = os.path.join(root, sub, seq, "meta", f"{f:04d}.pkl")
            os.makedirs(os.path.dirname(meta_path), exist_ok=True)
            with open(meta_path, "wb") as fh:
                pickle.dump(meta, fh)
            images.append((os.path.join(root, sub, seq, "rgb", f"{f:04d}{ext}"),
                           textured_image(rng, h, w) if bank is None else None))
            lines.append(f"{seq}/{f:04d}")

    def save(n):
        path, img = images[n]
        _save_image(path, img if bank is None else np.roll(bank[n % len(bank)], 7 * n, axis=1))

    with ThreadPoolExecutor(max_workers=8) as pool:  # the encoders release the GIL
        list(pool.map(save, range(len(images))))
    with open(os.path.join(root, f"{sub}.txt"), "a") as fh:
        fh.write("".join(line + "\n" for line in lines))
    return len(images)


DEXYCB_CAMS = ("836212060125", "839512060362")
DEXYCB_SUBJECTS = ("20200709-subject-01", "20200813-subject-02", "20200820-subject-03",
                   "20200903-subject-04", "20200908-subject-05", "20200918-subject-06",
                   "20200928-subject-07", "20201002-subject-08", "20201015-subject-09",
                   "20201022-subject-10")


def write_dexycb(data_root: str, n_subjects: int, n_scenes: int, n_frames: int,
                 rng: np.random.RandomState, test_frames: Optional[int] = None,
                 ycb_id: int = 5, ycb_name: str = "006_mustard_bottle",
                 cams: Sequence[str] = DEXYCB_CAMS) -> None:
    """``{data_root}/DexYCB/<subject>/<scene>/{meta.yml, <camera>/labels_*.npz,
    color_*.jpg}`` for the first ``n_subjects`` subjects, ``n_scenes``
    scenes each, ``n_frames`` frames a camera at 640 x 480 (``test_frames``
    in the scenes of the s0 test split: subjects 2-9, scenes 4 and 9): the right hand's 21 joints
    about the object (every other scene with MANO pose, translation and
    the subject's shape calibration), the object ``ycb_id`` 0.5 m ahead; the
    cameras' colour intrinsics; the object's ``textured_simple.obj`` (an
    ellipsoid of 3-4 cm), which the contact filter reads."""
    import yaml

    root = os.path.join(data_root, "DexYCB")
    calib = os.path.join(root, "calibration")
    os.makedirs(os.path.join(calib, "intrinsics"), exist_ok=True)
    for cam in cams:
        with open(os.path.join(calib, "intrinsics", f"{cam}_640x480.yml"), "w") as fh:
            yaml.safe_dump({"color": {"fx": 615.0, "fy": 615.0, "ppx": 320.0, "ppy": 240.0}}, fh)
    os.makedirs(os.path.join(calib, "mano_subject-01"), exist_ok=True)
    with open(os.path.join(calib, "mano_subject-01", "mano.yml"), "w") as fh:
        yaml.safe_dump({"betas": [0.1] * 10}, fh)
    images = []
    for si, subj in enumerate(DEXYCB_SUBJECTS[:n_subjects]):
        for seq in range(n_scenes):
            scene_dir = os.path.join(root, subj, f"2020{si:02d}_{seq:06d}")
            with_mano = seq % 2 == 0
            meta = {"mano_sides": ["right"], "serials": list(cams), "ycb_grasp_ind": 0,
                    "ycb_ids": [ycb_id]}
            if with_mano:
                meta["mano_calib"] = ["subject-01"]
            os.makedirs(scene_dir, exist_ok=True)
            with open(os.path.join(scene_dir, "meta.yml"), "w") as fh:
                yaml.safe_dump(meta, fh)
            for cam in cams:
                cam_dir = os.path.join(scene_dir, cam)
                os.makedirs(cam_dir, exist_ok=True)
                in_test = si >= 2 and seq % 5 == 4
                for f in range(test_frames if in_test and test_frames else n_frames):
                    pose_y = np.zeros((1, 3, 4), np.float32)
                    pose_y[0, :3, :3] = np.eye(3)
                    pose_y[0, :3, 3] = [0, 0, 0.5]
                    extra = {}
                    if with_mano:
                        pose_m = np.zeros((1, 51), np.float32)
                        pose_m[0, :48] = rng.randn(48) * 0.1
                        pose_m[0, 48:] = [0, 0, 0.5]
                        extra["pose_m"] = pose_m
                    np.savez(os.path.join(cam_dir, f"labels_{f:06d}.npz"),
                             joint_3d=(rng.randn(21, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
                             pose_y=pose_y, **extra)
                    images.append((os.path.join(cam_dir, f"color_{f:06d}.jpg"),
                                   rng.randint(0, 2**31 - 1)))

    def save(item):
        path, seed = item
        _save_image(path, textured_image(np.random.RandomState(seed), 480, 640))

    with ThreadPoolExecutor(max_workers=8) as pool:  # the encoders release the GIL
        list(pool.map(save, images))
    verts, _, faces = sphere_mesh(6, 8, rng.uniform(0.03, 0.04, 3))
    write_obj(os.path.join(root, "models", ycb_name, "textured_simple.obj"), verts, faces=faces)


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
        _save_image(os.path.join(d, "texture_map.png"), textured_image(rng, tex_size, tex_size))


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
        _save_image(os.path.join(bg_dir, f"bg_{i:03d}.jpg"), textured_image(rng, size[1], size[0]))


def write_html_hands(html_root: str, ids: Iterable[int], template: np.ndarray,
                     faces: np.ndarray, rng: np.random.RandomState, tex_size: int = 512):
    """``{html_root}/html_<id>/{hand.obj, texture.png}``: the MANO mesh with
    a UV per vertex (the template's x, y) and a texture."""
    lo, hi = template.min(0), template.max(0)
    uvs = (template[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)
    for i in ids:
        d = os.path.join(html_root, f"html_{i:03d}")
        write_obj(os.path.join(d, "hand.obj"), template, uvs, np.asarray(faces) + 1)
        _save_image(os.path.join(d, "texture.png"), textured_image(rng, tex_size, tex_size))


def write_imagenet_resnet(path: str, backbone_type: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A torchvision-named ResNet state dict (``fc`` included, BatchNorm
    statistics drawn) of ``backbone_type`` at ``path``. -> the tensors."""
    from artiboost_torch.models.resnet import build_resnet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = build_resnet({"TYPE": backbone_type})
        sd = {k: v.clone() for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        for k in sd:
            if k.endswith("running_mean"):
                sd[k].uniform_(-0.3, 0.3)
            elif k.endswith("running_var"):
                sd[k].uniform_(0.5, 1.5)
        sd["fc.weight"] = torch.randn(1000, net.out_channels) * 0.01
        sd["fc.bias"] = torch.zeros(1000)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return sd
