"""Per-CCV-triplet validation metrics driving the mining reweight
(counterpart of ``artiboost_tpu/metrics/val_metric.py``; reference
``anakin/metrics/val_metric.py:55-324``): a dense (O, V, G) (sum, count)
pair updated by one scatter-add per batch on the device. ``ValMetricMean3DEPE2``
holds the mean EPE per triplet, ``ValMetricAR2`` the symmetry-aware MSSD.
The BOP errors (``mssd_values``, ``mspd_values``, ``vsd_values``) are
shared with the test metric ``bop_ar.AR``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries, SynthQueries
from artiboost_torch.parallel.mesh import all_reduce_sum_
from artiboost_torch.utils.bop_sym import SymTable, sym_canonical
from artiboost_torch.utils.misc import resolve_device


class CCVMeter:
    """Dense (sum, count) accumulator over the CCV space."""

    def __init__(self, shape: Tuple[int, int, int], device=None):
        self.shape = tuple(shape)
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.sum_map = torch.zeros(self.shape, dtype=torch.float32, device=self.device)
        self.count_map = torch.zeros(self.shape, dtype=torch.float32, device=self.device)

    def update(self, oid, vid, gid, values, synth_flag):
        w = synth_flag.float()
        idx = (oid.long(), vid.long(), gid.long())
        self.sum_map.index_put_(idx, values.float() * w, accumulate=True)
        self.count_map.index_put_(idx, w, accumulate=True)

    def all_reduce(self):
        """Every rank's sum and count maps, summed (once, after a pass)."""
        both = all_reduce_sum_(torch.stack([self.sum_map, self.count_map]))
        self.sum_map, self.count_map = both[0], both[1]

    def averaged(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (avg_map, seen_mask)."""
        seen = self.count_map > 0
        return self.sum_map / torch.clamp_min(self.count_map, 1.0), seen

    def as_dict(self) -> Dict[Tuple[int, int, int], float]:
        """{(obj, persp, grasp): average} over the seen triplets (host)."""
        avg, seen = self.averaged()
        avg, seen = avg.cpu().numpy(), seen.cpu().numpy()
        return {tuple(int(i) for i in idx): float(avg[tuple(idx)]) for idx in np.argwhere(seen)}


def epe_values(pred: torch.Tensor, targ_rel: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """Mean end-point error per sample, (B, N, 3) -> (B,)."""
    return torch.linalg.norm(pred - (targ_rel + root[:, None]), dim=2).mean(dim=1)


class ValMetricMean3DEPE2:
    """Per-triplet mean EPE over VAL_KEYS (e.g. corners_3d_abs,
    joints_3d_abs against the root-relative targets + root)."""

    def __init__(self, VAL_KEYS, MILLIMETERS: bool = False, CCV_SHAPE=(21, 288, 50),
                 device=None, **_):
        device = resolve_device(device)
        self.val_keys_list = list(VAL_KEYS)
        self.to_millimeters = bool(MILLIMETERS)
        self.ccv_shape = tuple(CCV_SHAPE)
        self.meters = {k: CCVMeter(self.ccv_shape, device) for k in self.val_keys_list}
        self.reset()

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def all_reduce(self):
        for m in self.meters.values():
            m.all_reduce()

    def feed(self, preds: Dict, targs: Dict):
        synth = targs[SynthQueries.IS_SYNTH]
        # real samples carry id -1: clamp to 0, weight 0 via the synth flag
        oid = torch.clamp_min(targs[SynthQueries.OBJ_ID].long(), 0)
        vid = torch.clamp_min(targs[SynthQueries.PERSP_ID].long(), 0)
        gid = torch.clamp_min(targs[SynthQueries.GRASP_ID].long(), 0)
        for key in self.val_keys_list:
            targ_key = key.replace("_abs", "")
            vals = epe_values(preds[key].float(), targs[targ_key].float(),
                              targs[Queries.ROOT_JOINT].float())
            if self.to_millimeters:
                vals = vals * 1000.0
            self.meters[key].update(oid, vid, gid, vals, synth)

    def get_averaged_maps(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (avg_map, seen_mask), averaged over VAL_KEYS."""
        maps = [m.averaged() for m in self.meters.values()]
        return sum(m[0] for m in maps) / len(maps), maps[0][1]

    def get_measures(self) -> Dict[str, Dict[Tuple[int, int, int], float]]:
        """Per VAL_KEY, the seen triplets' averages (``val_metric.py:107-108``)."""
        return {k: self.meters[k].as_dict() for k in self.val_keys_list}

    def get_scalar_measures(self) -> Dict[str, float]:
        """The mean over seen triplets, for the scalar dumps
        (``val_metric.py:125-131``)."""
        avg, seen = self.get_averaged_maps()
        seen_f = seen.float()
        return {"val_epe_mean": float(torch.sum(avg * seen_f)
                                      / torch.clamp_min(torch.sum(seen_f), 1.0))}

    def __str__(self):
        return ""


def _sym_pred_abs(pred_rot, pred_tsl, obj_can, obj_transf, sym_R, sym_t, use_ho3d_ycb):
    """The ground-truth-posed points under each symmetry (B, S, V, 3) and
    the prediction-posed points (B, V, 3): the core of MSSD and MSPD."""
    sym_can = sym_canonical(sym_R, sym_t, obj_can, use_ho3d_ycb)
    sym_abs = (torch.einsum("bij,bsvj->bsvi", obj_transf[:, :3, :3], sym_can)
               + obj_transf[:, None, None, :3, 3])
    return sym_abs, torch.einsum("bij,bvj->bvi", pred_rot, obj_can) + pred_tsl


def _masked_maxmin(d: torch.Tensor, pad_mask: torch.Tensor, sym_valid: torch.Tensor
                   ) -> torch.Tensor:
    """(B, S, V) -> (B,): the max over valid points, then the min over
    valid symmetries (invalid ones take float32's max)."""
    d_max = torch.where(pad_mask[:, None, :] > 0, d, 0.0).amax(dim=-1)
    return torch.where(sym_valid > 0, d_max, torch.finfo(d_max.dtype).max).amin(dim=-1)


def mssd_values(pred_rot, pred_tsl, obj_can, pad_mask, obj_transf, sym_R, sym_t, sym_valid,
                use_ho3d_ycb: bool = False) -> torch.Tensor:
    """Maximum symmetry-aware surface distance in metres, (B,): the min over
    symmetries of the max over valid points of |T_gt S x - T_pred x|
    (reference val_metric.py:294-315). pred_rot (B, 3, 3), pred_tsl
    (B, 1, 3), obj_can (B, V, 3), pad_mask (B, V), obj_transf (B, 4, 4)."""
    sym_abs, pred_abs = _sym_pred_abs(pred_rot, pred_tsl, obj_can, obj_transf, sym_R, sym_t,
                                      use_ho3d_ycb)
    return _masked_maxmin(torch.linalg.norm(sym_abs - pred_abs[:, None], dim=-1),
                          pad_mask, sym_valid)


def mspd_values(pred_rot, pred_tsl, obj_can, pad_mask, obj_transf, intr, sym_R, sym_t,
                sym_valid, use_ho3d_ycb: bool = False) -> torch.Tensor:
    """Maximum symmetry-aware projection distance in pixels, (B,), in the
    eval image's crop space with its intrinsics ``intr`` (B, 3, 3): the JAX
    package's convention, which departs from BOP's source-image MSPD
    (``artiboost_tpu/metrics/val_metric.py`` ``mspd_values``)."""
    sym_abs, pred_abs = _sym_pred_abs(pred_rot, pred_tsl, obj_can, obj_transf, sym_R, sym_t,
                                      use_ho3d_ycb)

    def proj(p, expand):
        z = torch.clamp_min(p[..., 2], 1e-6)
        shape = (-1,) + (1,) * expand
        fx, fy = intr[:, 0, 0].reshape(shape), intr[:, 1, 1].reshape(shape)
        cx, cy = intr[:, 0, 2].reshape(shape), intr[:, 1, 2].reshape(shape)
        return torch.stack([p[..., 0] / z * fx + cx, p[..., 1] / z * fy + cy], dim=-1)

    d = torch.linalg.norm(proj(sym_abs, 2) - proj(pred_abs, 1)[:, None], dim=-1)
    return _masked_maxmin(d, pad_mask, sym_valid)


VSD_BIG = 1e9


def _splat_depth(px, py, z, valid, res: int) -> torch.Tensor:
    """Point-splat z-buffer: (B, V) grid coordinates and depths -> (B, res,
    res) distance map, empty cells VSD_BIG. A scatter-min over res*res + 1
    cells per sample, the last one taking the points that fall outside.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    ix = torch.round(px).clamp(-1, res).to(torch.int64)
    iy = torch.round(py).clamp(-1, res).to(torch.int64)
    inb = valid & (ix >= 0) & (ix < res) & (iy >= 0) & (iy < res) & (z > 1e-6)
    lin = torch.where(inb, iy * res + ix, res * res)
    zz = torch.where(inb, z, VSD_BIG).float()
    d = torch.full((px.shape[0], res * res + 1), VSD_BIG, dtype=torch.float32, device=px.device)
    d = d.scatter_reduce(1, lin, zz, "amin", include_self=True)
    return d[:, :res * res].reshape(-1, res, res)


def _fill_holes(d: torch.Tensor, iters: int) -> torch.Tensor:
    """Fill each empty cell with its 3x3 neighbourhood's min, ``iters``
    times: closes the gaps a finite vertex cloud leaves between splats."""
    res = d.shape[-1]
    for _ in range(iters):
        p = torch.nn.functional.pad(d, (1, 1, 1, 1), value=VSD_BIG)
        m = d
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, p[:, dy:dy + res, dx:dx + res])
        d = torch.where(d >= VSD_BIG * 0.5, m, d)
    return d


def vsd_values(pred_rot, pred_tsl, obj_can, pad_mask, obj_transf, intr, taus,
               image_size: float, res: int = 64, dilate: int = 2) -> torch.Tensor:
    """Visible surface discrepancy, approximated -> (B, n_tau) in [0, 1]:
    distance maps of the canonical vertex cloud point-splatted at res^2
    (``dilate`` rounds of hole filling) in the predicted and ground-truth
    poses, object-only visibility; over the union of the two masks, the
    share of pixels seen in one map only or differing in depth by at least
    tau (``taus`` (B, n_tau), metres). An empty union scores 0. The JAX
    package's extension beyond the reference (``val_metric.py``
    ``vsd_values`` documents both approximations)."""
    pred_abs = torch.einsum("bij,bvj->bvi", pred_rot, obj_can) + pred_tsl
    gt_abs = (torch.einsum("bij,bvj->bvi", obj_transf[:, :3, :3], obj_can)
              + obj_transf[:, None, :3, 3])
    scale = res / float(image_size)
    valid = pad_mask > 0

    def to_grid(p):
        z = torch.clamp_min(p[..., 2], 1e-6)
        px = (p[..., 0] / z * intr[:, None, 0, 0] + intr[:, None, 0, 2]) * scale
        py = (p[..., 1] / z * intr[:, None, 1, 1] + intr[:, None, 1, 2]) * scale
        return px, py, p[..., 2]

    d_est = _fill_holes(_splat_depth(*to_grid(pred_abs), valid, res), dilate)
    d_gt = _fill_holes(_splat_depth(*to_grid(gt_abs), valid, res), dilate)
    va, vb = d_est < VSD_BIG * 0.5, d_gt < VSD_BIG * 0.5
    union, inter = va | vb, va & vb
    match = inter[:, None] & ((d_est - d_gt).abs()[:, None] < taus[:, :, None, None])
    err = union[:, None] & ~match
    union_n = torch.clamp_min(union.sum(dim=(1, 2)), 1)
    return err.sum(dim=(2, 3)) / union_n[:, None]


class OnesPad:
    """An all-ones (B, V) padding mask, made again only when the batch's
    shape changes (a TEST pass's padded tail keeps the shape)."""

    def __init__(self):
        self.mask: Optional[torch.Tensor] = None

    def __call__(self, like: torch.Tensor) -> torch.Tensor:
        shape = tuple(like.shape[:2])
        if (self.mask is None or tuple(self.mask.shape) != shape
                or self.mask.device != like.device):
            self.mask = torch.ones(shape, dtype=torch.float32, device=like.device)
        return self.mask


class ValMetricAR2:
    """Per-triplet MSSD in millimetres (reference val_metric.py:146-324),
    on the object's vertices or, with MSSD_USE_CORNERS, its box corners."""

    def __init__(self, USE_MSSD: bool = True, MSSD_USE_CORNERS: bool = False,
                 USE_HO3D_YCB: bool = False, CCV_SHAPE=(21, 288, 50), MODEL_INFO_PATH=None,
                 MAX_SYM_DISC_STEP: float = 0.01, device=None, **_):
        self.mssd_use_corners = bool(MSSD_USE_CORNERS)
        self.use_ho3d_ycb = bool(USE_HO3D_YCB)
        self.ccv_shape = tuple(CCV_SHAPE)
        self.syms = SymTable(MODEL_INFO_PATH or None, MAX_SYM_DISC_STEP)
        self.meter = CCVMeter(self.ccv_shape, resolve_device(device))
        self.ones_pad = OnesPad()

    def reset(self):
        self.meter.reset()

    def all_reduce(self):
        self.meter.all_reduce()

    def feed(self, preds: Dict, targs: Dict):
        obj_idx0 = torch.clamp_min(targs[Queries.OBJ_IDX].long() - 1, 0)
        obj_can = targs[Queries.CORNERS_CAN if self.mssd_use_corners else Queries.OBJ_VERTS_CAN]
        pad = targs.get(Queries.PADDING_MASK)
        if pad is None or self.mssd_use_corners:
            pad = self.ones_pad(obj_can)
        vals = mssd_values(preds["box_rot_rotmat"].float(),
                           preds["boxroot_3d_abs"].float().reshape(-1, 1, 3), obj_can.float(),
                           pad, targs[Queries.OBJ_TRANSF].float(), *self.syms.gather(obj_idx0),
                           self.use_ho3d_ycb) * 1000.0
        oid = torch.clamp_min(targs[SynthQueries.OBJ_ID].long(), 0)
        vid = torch.clamp_min(targs[SynthQueries.PERSP_ID].long(), 0)
        gid = torch.clamp_min(targs[SynthQueries.GRASP_ID].long(), 0)
        self.meter.update(oid, vid, gid, vals, targs[SynthQueries.IS_SYNTH])

    def get_averaged_maps(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.meter.averaged()

    def get_measures(self) -> Dict[str, Dict[Tuple[int, int, int], float]]:
        return {"mssd": self.meter.as_dict()}

    def get_scalar_measures(self) -> Dict[str, float]:
        avg, seen = self.meter.averaged()
        seen_f = seen.float()
        return {"val_mssd_mean": float(torch.sum(avg * seen_f)
                                       / torch.clamp_min(torch.sum(seen_f), 1.0))}

    def __str__(self):
        return ""
