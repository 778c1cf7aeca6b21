"""Real-data pipeline: the HODataset base class (counterpart of
``artiboost_tpu/datasets/hodata.py``; reference ``anakin/datasets/hodata.py``).

The accessor contract (get_image / get_joints_3d / ...), the per-sample
geometry (side flip, bbox crop with jitter, affine and intrinsics update,
root-relative joints and corners, OBJ_TRANSF rotation, the 40 % visibility
rules, MANO annotations) and batch assembly with vertex padding.

A batch is made in two halves. The host half (``host_half``) draws the
geometry and its augmentation in numpy, from the dataset's own
``np.random.RandomState(SEED)`` (:83, draws :243-258) in index order, so
the port and the JAX package draw the same numbers; a dataset whose images
are files decodes them there, into one uint8 (N, H, W, 3) RGB array (a
pinned staging buffer of ``utils/prefetch.py`` when the batches are
prefetched), by a pool of decode threads when one is given. The host half
makes no CUDA call, so a worker thread can run it. The device half
(``device_half``) copies the images to the device, or gathers them there
for a dataset that keeps them on the device (``SyntheticHO``), flips the
left-hand ones and runs the batched warp (``warp_affine_batch``): the
semantics of the JAX package's default image path,
``native/hostops.cpp`` (:55-116)."""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries, SynthQueries
from artiboost_torch.mano.numpy_fk import aa_to_rotmat_np, mirror_mano_pose, rotmat_to_aa_np
from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import CONST, resolve_device
from artiboost_torch.utils.prefetch import IN_PLACE


def _np_affine(center, scale, optical_center, out_res, rot):
    """(crop affine, post-rotation affine), numpy, as hodata.py:27-52."""
    cs, sn = np.cos(rot), np.sin(rot)
    rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float32)
    hom = np.array([center[0], center[1], 1.0], np.float32)
    origin_rot_center = (rot_mat @ hom)[:2]
    t_mat = np.eye(3, dtype=np.float32)
    t_mat[0, 2], t_mat[1, 2] = -optical_center[0], -optical_center[1]
    t_inv = t_mat.copy()
    t_inv[:2, 2] *= -1
    transformed_center = (t_inv @ rot_mat @ t_mat @ hom)[:2]

    def no_rot(c):
        res0, res1 = float(out_res[0]), float(out_res[1])
        ratio = res0 / res1
        a = np.zeros((3, 3), np.float32)
        a[0, 0] = res0 / scale
        a[1, 1] = res1 / scale * ratio
        a[0, 2] = res0 * (-c[0] / scale + 0.5)
        a[1, 2] = res1 * (-c[1] / scale * ratio + 0.5)
        a[2, 2] = 1
        return a

    return no_rot(origin_rot_center) @ rot_mat, no_rot(transformed_center)


def _transform_coords(pts, A):
    hom = np.concatenate([pts, np.ones_like(pts[:, :1])], 1)
    return (A @ hom.T).T[:, :2]


def _bilinear_zero(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """src (N, H, W, 3) uint8, sample points (N, h, w) in raw pixels (the
    integer-pixel convention) -> (N, h, w, 3) float32 in [0, 1]; the
    neighbours outside the image count as 0."""
    N, H, W, _ = src.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = src.reshape(N, H * W, 3)

    def px(yy, xx):
        inside = ((xx >= 0) & (yy >= 0) & (xx < W) & (yy < H))[..., None]
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(N, -1, 1).expand(-1, -1, 3)
        v = torch.gather(flat, 1, idx).reshape(xx.shape + (3,)).float() * (1.0 / 255.0)
        return torch.where(inside, v, 0.0)

    fx, fy = fx[..., None], fy[..., None]
    top = (1 - fx) * px(y0, x0) + fx * px(y0, x0 + 1)
    bottom = (1 - fx) * px(y0 + 1, x0) + fx * px(y0 + 1, x0 + 1)
    return (1 - fy) * top + fy * bottom


def _blur5(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable gaussian of radius 2 with edge clamping, horizontal then
    vertical, on the samples whose sigma > 0.1 (hostops.cpp:74-104)."""
    i = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    s2 = torch.clamp_min(sigma * sigma, 1e-12)[:, None]
    k = torch.exp(-0.5 * i * i / s2)
    k = k / k.sum(dim=1, keepdim=True)  # (N, 5)
    H, W = img.shape[1], img.shape[2]
    xs = torch.clamp(torch.arange(W, device=img.device)[:, None] + torch.arange(-2, 3, device=img.device), 0, W - 1)
    ys = torch.clamp(torch.arange(H, device=img.device)[:, None] + torch.arange(-2, 3, device=img.device), 0, H - 1)
    out = 0
    for j in range(5):
        out = out + k[:, j, None, None, None] * img[:, :, xs[:, j]]
    res = 0
    for j in range(5):
        res = res + k[:, j, None, None, None] * out[:, ys[:, j]]
    return torch.where((sigma > 0.1)[:, None, None, None], res, img)


def warp_affine_batch(images: torch.Tensor, inv_affines: torch.Tensor, jitter: torch.Tensor,
                      out_h: int, out_w: int) -> torch.Tensor:
    """Batched crop warp + blur + colour jitter + normalisation on the
    device: images (N, H, W, 3) uint8, inv_affines (N, 2, 3) crop -> raw,
    jitter (N, 4) (brightness, contrast, saturation, blur sigma) ->
    (N, out_h, out_w, 3) float32 in [-0.5, 0.5].

    dst(x, y) = bilinear src(inv . (x, y, 1)) with integer pixel
    coordinates and zero outside, then the blur, brightness, contrast about
    the image mean, saturation about the per-pixel gray, clip and -0.5.
    The bilinear sample is four gathers in the native library's own
    arithmetic: ``grid_sample`` would renormalise the coordinates to
    [-1, 1] and back, which moves them by up to ~3e-5 pixel and an 8-bit
    edge by as much."""
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(out_h, device=dev, dtype=torch.float32),
                            torch.arange(out_w, device=dev, dtype=torch.float32), indexing="ij")
    a = inv_affines.float()[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    sx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    sy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    img = _blur5(_bilinear_zero(images, sx, sy), jitter[:, 3])
    j = jitter[:, :3, None, None, None].float()
    img = img * j[:, 0]
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * j[:, 1] + mean
    gray = (img[..., 0:1] + img[..., 1:2] + img[..., 2:3]) * (1.0 / 3.0)
    return torch.clamp((img - gray) * j[:, 2] + gray, 0.0, 1.0) - 0.5


def decode_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: ``cv2.imread`` and BGR -> RGB,
    as the JAX package reads."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise OSError(f"cannot identify image file {path!r}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class HostBatch(NamedTuple):
    """The host half of a batch: per-sample geometry without the pixels,
    the crop warp's inputs and the decoded images (None for a dataset that
    keeps its images on the device), the staging ring and slot that hold
    them, if one does, and the host seconds of the geometry and of the
    decode."""
    geoms: List[Dict]
    sample_idx: List[int]
    flips: np.ndarray        # (N,) bool
    inv_affines: np.ndarray  # (N, 2, 3) float32, crop -> raw
    jitter: np.ndarray       # (N, 4) float32
    images: Optional[np.ndarray] = None  # (N, H, W, 3) uint8 RGB
    staging: Optional[object] = None     # utils.prefetch.StagingRing
    slot: Optional[int] = None
    seconds: Tuple[float, float] = (0.0, 0.0)


class HODataset(ABC):
    """Abstract hand-object dataset with the reference accessor contract.
    A file-backed dataset implements ``get_image`` (decoded on the host); a
    dataset that keeps its images on ``device`` as uint8 sets
    ``images_on_host = False`` and implements ``get_images``. Batches come
    out on ``device``."""

    images_on_host = True

    def __init__(self, DATA_PRESET: Dict, device=None, **cfg):
        preset = DATA_PRESET
        self.device = resolve_device(device)
        self.data_root = cfg.get("DATA_ROOT", "./data")
        self.data_split = cfg.get("DATA_SPLIT", "train")
        self.use_cache = preset.get("USE_CACHE", True)
        self.filter_no_contact = preset.get("FILTER_NO_CONTACT", False)
        self.filter_thresh = float(preset.get("FILTER_THRESH", 0.0))
        self.mini_factor = float(cfg.get("MINI_FACTOR", 1.0))
        self.bbox_expand_ratio = float(preset.get("BBOX_EXPAND_RATIO", 1.2))
        self.crop_model = preset.get("CROP_MODEL", "hand_obj")
        self.require_full_image = preset.get("FULL_IMAGE", False)
        if self.require_full_image:
            self.bbox_expand_ratio = 1.0
        self.aug = cfg.get("AUG", False)
        self.raw_size = (256, 256)  # set by subclasses
        self.image_size = tuple(preset.get("IMAGE_SIZE", (224, 224)))
        self.center_idx = int(preset.get("CENTER_IDX", 9))
        self.sides = CONST.SIDE
        self.njoints = CONST.NUM_JOINTS
        self.ncorners = CONST.NUM_CORNERS
        self.rng = np.random.RandomState(cfg.get("SEED", 1))
        if self.aug:
            self.saturation, self.contrast, self.brightness = 0.1, 0.1, 0.1
            self.blur_radius = 0.1
            aug_param = cfg.get("AUG_PARAM") or {}
            self.scale_jittering = aug_param.get("SCALE_JIT", 0.0)
            self.center_jittering = aug_param.get("CENTER_JIT", 0.0)
            self.max_rot = aug_param.get("MAX_ROT", 0.0) * np.pi
        else:
            self.saturation = self.contrast = self.brightness = 0.0
            self.blur_radius = 0.0
            self.scale_jittering = self.center_jittering = self.max_rot = 0.0

    # ---- accessor contract ----
    @abstractmethod
    def __len__(self) -> int: ...

    def get_image(self, idx) -> np.ndarray:
        """(H, W, 3) uint8 RGB of sample ``idx``, from its file."""
        raise NotImplementedError(f"{type(self).__name__} keeps its images on the device")

    def get_images(self, idx: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device, for ``images_on_host = False``."""
        raise NotImplementedError(f"{type(self).__name__} decodes its images on the host")

    @abstractmethod
    def get_cam_intr(self, idx) -> np.ndarray: ...   # (3, 3)

    @abstractmethod
    def get_joints_3d(self, idx) -> np.ndarray: ...  # (21, 3) camera space

    @abstractmethod
    def get_corners_3d(self, idx) -> np.ndarray: ...

    @abstractmethod
    def get_corners_can(self, idx) -> np.ndarray: ...

    @abstractmethod
    def get_obj_transf(self, idx) -> np.ndarray: ...  # (4, 4)

    @abstractmethod
    def get_obj_idx(self, idx) -> int: ...

    def get_obj_verts_can(self, idx) -> Optional[np.ndarray]:
        return None

    def get_hand_pose(self, idx) -> Optional[np.ndarray]:
        """(48,) axis-angle MANO pose wrt the camera, or None."""
        return None

    def get_hand_shape(self, idx) -> Optional[np.ndarray]:
        return None

    def get_hand_verts_3d(self, idx) -> Optional[np.ndarray]:
        return None

    def get_sides(self, idx) -> str:
        return self.sides

    def get_sample_idxs(self) -> np.ndarray:
        return np.arange(len(self))

    def get_joints_2d(self, idx) -> np.ndarray:
        hom = (self.get_cam_intr(idx) @ self.get_joints_3d(idx).T).T
        return hom[:, :2] / np.maximum(hom[:, 2:], 1e-8)

    def get_corners_2d(self, idx) -> np.ndarray:
        hom = (self.get_cam_intr(idx) @ self.get_corners_3d(idx).T).T
        return hom[:, :2] / np.maximum(hom[:, 2:], 1e-8)

    def get_center_scale_wrt_bbox(self, idx):
        if self.require_full_image:
            return (np.array([self.raw_size[0] / 2, self.raw_size[1] / 2], np.float32),
                    float(self.raw_size[0]))
        if self.crop_model == "hand":
            pts = self.get_joints_2d(idx)
        elif self.crop_model == "root_obj":
            pts = np.concatenate([self.get_joints_2d(idx)[[0]], self.get_corners_2d(idx)], 0)
        else:  # hand_obj
            pts = np.concatenate([self.get_joints_2d(idx), self.get_corners_2d(idx)], 0)
        lo, hi = pts.min(0), pts.max(0)
        return (lo + hi) / 2.0, float(max(hi - lo))

    def _vis_rule(self, raw_2d, crop_2d, n):
        """40 %-visibility rule (reference hodata.py:390-432); all ones on
        evaluation splits."""
        if self.data_split not in ("train", "trainval"):
            return np.ones(n, np.float32)
        in_raw = ((raw_2d[:, 0] >= 0) & (raw_2d[:, 0] < self.raw_size[0])
                  & (raw_2d[:, 1] >= 0) & (raw_2d[:, 1] < self.raw_size[1]))
        if in_raw.sum() < n * 0.4:
            return np.zeros(n, np.float32)
        in_crop = ((crop_2d[:, 0] >= 0) & (crop_2d[:, 0] < self.image_size[0])
                   & (crop_2d[:, 1] >= 0) & (crop_2d[:, 1] < self.image_size[1])
                   ).astype(np.float32)
        if in_crop.sum() < n * 0.4:
            return np.zeros(n, np.float32)
        return in_crop

    def _flip_2d(self, pts):
        out = pts.copy()
        out[:, 0] = self.raw_size[0] - out[:, 0]
        return out

    @staticmethod
    def _flip_3d(pts):
        out = pts.copy()
        out[:, 0] *= -1
        return out

    def _make_geom(self, idx) -> Dict:
        """Everything but the pixels: annotations, the crop affine and the
        augmentation draws (hodata.py:213-332)."""
        idx = int(self.get_sample_idxs()[idx])
        sample: Dict = {SynthQueries.IS_SYNTH: 0, SynthQueries.OBJ_ID: -1,
                        SynthQueries.PERSP_ID: -1, SynthQueries.GRASP_ID: -1}
        flip = self.get_sides(idx) != self.sides
        bbox_center, bbox_scale = self.get_center_scale_wrt_bbox(idx)
        bbox_scale *= self.bbox_expand_ratio

        cam_intr = self.get_cam_intr(idx).astype(np.float32).copy()
        joints_3d = self.get_joints_3d(idx).astype(np.float32)
        joints_2d = self.get_joints_2d(idx).astype(np.float32)
        corners_3d = self.get_corners_3d(idx).astype(np.float32)
        corners_2d = self.get_corners_2d(idx).astype(np.float32)
        corners_can = self.get_corners_can(idx).astype(np.float32)
        if flip:
            bbox_center = bbox_center.copy()
            bbox_center[0] = self.raw_size[0] - bbox_center[0]
            joints_3d, corners_3d = self._flip_3d(joints_3d), self._flip_3d(corners_3d)
            joints_2d, corners_2d = self._flip_2d(joints_2d), self._flip_2d(corners_2d)

        if self.aug:
            center_jit = self.rng.uniform(-1, 1, 2)
            bbox_center = bbox_center + (self.center_jittering * bbox_scale * center_jit).astype(int)
            jit = np.clip(self.rng.normal(0, self.scale_jittering / 3.0) + 1.0,
                          1 - self.scale_jittering, 1 + self.scale_jittering)
            bbox_scale = bbox_scale * jit
            rot_rad = self.rng.uniform(-self.max_rot, self.max_rot)
            jitter = np.array([
                self.rng.uniform(1 - self.brightness, 1 + self.brightness),
                self.rng.uniform(1 - self.contrast, 1 + self.contrast),
                self.rng.uniform(1 - self.saturation, 1 + self.saturation),
                self.rng.uniform(0, 1) * self.blur_radius * 3,
            ], np.float32)
        else:
            rot_rad = 0.0
            jitter = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

        rot_mat = np.array([[np.cos(rot_rad), -np.sin(rot_rad), 0],
                            [np.sin(rot_rad), np.cos(rot_rad), 0],
                            [0, 0, 1]], np.float32)
        affine_transf, post_rot_transf = _np_affine(
            bbox_center, bbox_scale, (cam_intr[0, 2], cam_intr[1, 2]), self.image_size, rot_rad)
        sample[Queries.CAM_INTR] = (post_rot_transf @ cam_intr).astype(np.float32)

        joints_3d = (rot_mat @ joints_3d.T).T
        root_joint = joints_3d[self.center_idx]
        sample[Queries.ROOT_JOINT] = root_joint
        sample[Queries.JOINTS_3D] = joints_3d - root_joint
        joints_2d_crop = _transform_coords(joints_2d, affine_transf).astype(np.float32)
        sample[Queries.JOINTS_2D] = joints_2d_crop
        sample[Queries.JOINTS_VIS] = self._vis_rule(joints_2d, joints_2d_crop, self.njoints)

        corners_3d = (rot_mat @ corners_3d.T).T
        sample[Queries.CORNERS_3D] = corners_3d - root_joint
        corners_2d_crop = _transform_coords(corners_2d, affine_transf).astype(np.float32)
        sample[Queries.CORNERS_2D] = corners_2d_crop
        sample[Queries.CORNERS_CAN] = corners_can
        sample[Queries.OBJ_IDX] = self.get_obj_idx(idx)
        sample[Queries.CORNERS_VIS] = self._vis_rule(corners_2d, corners_2d_crop, self.ncorners)

        base = self.get_obj_transf(idx).astype(np.float32)
        transf = np.eye(4, dtype=np.float32)
        transf[:3, :3] = rot_mat[:3, :3] @ base[:3, :3]
        transf[:3, 3] = rot_mat[:3, :3] @ base[:3, 3]
        sample[Queries.OBJ_TRANSF] = transf

        verts_can = self.get_obj_verts_can(idx)
        if verts_can is not None:
            sample[Queries.OBJ_VERTS_CAN] = verts_can.astype(np.float32)
            v3d = verts_can @ transf[:3, :3].T + transf[:3, 3]
            sample[Queries.OBJ_VERTS_3D] = (v3d - root_joint).astype(np.float32)

        hand_verts = self.get_hand_verts_3d(idx)
        if hand_verts is not None:
            hv = hand_verts.astype(np.float32)
            if flip:
                hv = self._flip_3d(hv)
            sample[Queries.HAND_VERTS_3D] = ((rot_mat @ hv.T).T - root_joint).astype(np.float32)
        hand_pose = self.get_hand_pose(idx)
        if hand_pose is not None:
            hp = np.asarray(hand_pose, np.float32).copy()
            if flip:
                hp = mirror_mano_pose(hp)
            hp[:3] = rotmat_to_aa_np(rot_mat[:3, :3] @ aa_to_rotmat_np(hp[:3]))
            sample[Queries.HAND_POSE] = hp
        hand_shape = self.get_hand_shape(idx)
        if hand_shape is not None:
            sample[Queries.HAND_SHAPE] = np.asarray(hand_shape, np.float32)
        sample[Queries.SAMPLE_IDX] = idx
        sample["_affine"] = affine_transf
        sample["_jitter"] = jitter
        sample["_flip"] = flip
        return sample

    def host_half(self, idx_list: Sequence[int], pool=None, staging=None) -> HostBatch:
        """The geometry of every sample, in order, then the decode of the
        file-backed images into one (N, H, W, 3) uint8 array: a buffer taken
        from ``staging`` (``utils.prefetch.StagingRing``) or a new one. The
        decode runs on ``pool`` (an executor) when given; the geometry and
        its draws stay on the calling thread."""
        t0 = time.perf_counter()
        with profiling.trace("data/real_geometry"):
            geoms = [self._make_geom(i) for i in idx_list]
            sidx = [int(g[Queries.SAMPLE_IDX]) for g in geoms]
            flips = np.array([bool(g.pop("_flip")) for g in geoms])
            inv = np.stack([np.linalg.inv(g.pop("_affine"))[:2] for g in geoms]
                           ).astype(np.float32)
            jitter = np.stack([g.pop("_jitter") for g in geoms]).astype(np.float32)
        t1 = time.perf_counter()
        if not self.images_on_host:
            return HostBatch(geoms, sidx, flips, inv, jitter, seconds=(t1 - t0, 0.0))
        shape = (len(sidx), self.raw_size[1], self.raw_size[0], 3)
        slot, images = staging.take(shape) if staging is not None else (
            None, np.empty(shape, np.uint8))

        def decode(k):
            img = self.get_image(sidx[k])
            if img.shape != shape[1:]:
                raise ValueError(f"{type(self).__name__} sample {sidx[k]}: image "
                                 f"{img.shape}, expected {shape[1:]} (raw_size {self.raw_size})")
            images[k] = img

        try:
            with profiling.trace("data/real_decode"):
                if pool is None:
                    for k in range(len(sidx)):
                        decode(k)
                else:
                    list(pool.map(decode, range(len(sidx))))
        except BaseException:
            if staging is not None:
                staging.give_back(slot)
            raise
        return HostBatch(geoms, sidx, flips, inv, jitter, images, staging, slot,
                         (t1 - t0, time.perf_counter() - t1))

    def device_half(self, host: HostBatch, rows: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Upload (or gather on the device), flip, warp, collate. Runs on
        the thread that owns the device stream. ``rows`` = (lo, hi): only
        those rows of the host half (a rank's share, ``mesh.rows``), their
        vertex fields padded to the whole host half's longest."""
        lo, hi = (0, len(host.sample_idx)) if rows is None else rows
        with profiling.trace("data/real_device"):
            if host.images is None:
                images = self.get_images(torch.as_tensor(host.sample_idx[lo:hi],
                                                         device=self.device))
            elif host.staging is not None:
                images = host.staging.upload(host.slot, self.device)[lo:hi]
            else:
                images = torch.from_numpy(host.images[lo:hi]).to(self.device)
            flips = torch.as_tensor(host.flips[lo:hi], device=self.device)
            images = torch.where(flips[:, None, None, None], images.flip(2), images)
            batch = ho_collate(host.geoms[lo:hi], self.device,
                               pad_to=None if rows is None else _longest_verts(host.geoms))
            batch[Queries.IMAGE] = warp_affine_batch(
                images, torch.from_numpy(host.inv_affines[lo:hi]).to(self.device),
                torch.from_numpy(host.jitter[lo:hi]).to(self.device), self.image_size[1],
                self.image_size[0])
            return batch

    def sample_batch(self, idx_list: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Batch assembly on the calling thread: the host half, then the
        device half."""
        return self.device_half(self.host_half(idx_list))


def padded_host_loader(dataset: HODataset, batch_size: int, shuffle: bool = False,
                       seed: int = 0, host=None, rows: Optional[Tuple[int, int]] = None):
    """Batches over the WHOLE dataset for evaluation passes: the last
    partial batch is repeat-padded to ``batch_size`` and carries
    ``Queries.SAMPLE_VALID`` (1 real / 0 pad), which the metrics honour.
    The host halves come from ``host`` (a ``utils.prefetch.HostPipeline``;
    made in place without one), as the train pass's do; the device halves
    run on the calling thread. With ``rows`` = (lo, hi) each batch is those
    rows of the global one."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    plan = ((idx + [idx[-1]] * (batch_size - len(idx)), len(idx))
            for idx in (order[s:s + batch_size].tolist()
                        for s in range(0, len(order), batch_size)))
    lo, hi = (0, batch_size) if rows is None else rows
    for hb, n_valid in (host or IN_PLACE).host_halves(dataset, plan, batch_size):
        batch = dataset.device_half(hb, rows=rows)
        if n_valid < batch_size:
            valid = torch.zeros((batch_size,), dtype=torch.float32, device=dataset.device)
            valid[:n_valid] = 1.0
            batch[Queries.SAMPLE_VALID] = valid[lo:hi]
        yield batch


_VERTEX_FIELDS = (Queries.OBJ_VERTS_3D, Queries.OBJ_VERTS_CAN, Queries.OBJ_VERTS_2D)


def _longest_verts(samples: List[Dict]) -> Optional[int]:
    """The most object vertices of any sample, None without vertex fields."""
    present = [q for q in _VERTEX_FIELDS if q in samples[0]]
    return max(s[present[0]].shape[0] for s in samples) if present else None


def ho_collate(samples: List[Dict], device, pad_to: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """Stack sample dicts into device tensors; repeat-pad the
    variable-size vertex fields (to ``pad_to``, default the longest) and
    emit PADDING_MASK (hodata.py:407)."""
    out: Dict[str, torch.Tensor] = {}
    present = [q for q in _VERTEX_FIELDS if q in samples[0]]
    if present:
        max_size = pad_to or _longest_verts(samples)
        mask = np.zeros((len(samples), max_size), np.float32)
        for bi, s in enumerate(samples):
            mask[bi, :s[present[0]].shape[0]] = 1.0
            for q in present:
                v = s[q]
                s[q] = np.concatenate([v] * int(max_size / v.shape[0] + 1))[:max_size]
        out[Queries.PADDING_MASK] = torch.from_numpy(mask).to(device)
    for k in samples[0]:
        out[k] = torch.from_numpy(np.stack([np.asarray(s[k]) for s in samples])).to(device)
    return out
