"""The test-time BOP metric (counterpart of ``artiboost_tpu/metrics/bop_ar.py``;
reference ``anakin/metrics/bopAR.py:16-190``): the symmetry-aware MSSD per
sample and per object, and the BOP average recalls: AR_MSSD over 0.05..0.5
of the object's diameter, AR_MSPD over 5..50 px scaled by the image width
over 640 (on by default), AR_VSD behind ``USE_VSD``, and their means
AR_BOP2 and AR_BOP. The per-sample errors stay on the device until the
measures are read; repeat-padded rows of a TEST tail (SAMPLE_VALID 0) take
object id -1 and are dropped there."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.metrics.val_metric import OnesPad, mspd_values, mssd_values, vsd_values
from artiboost_torch.parallel.mesh import all_gather_rows
from artiboost_torch.utils.bop_sym import SymTable, load_model_info
from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.registry import METRIC

N_THRESHOLDS = 10


@METRIC.register_module
class AR:
    def __init__(self, USE_MSSD: bool = True, MSSD_USE_CORNERS: bool = False,
                 USE_HO3D_YCB: bool = False, USE_MSPD: bool = True, USE_VSD: bool = False,
                 VSD_RES: int = 64, VSD_DILATE: int = 2, MODEL_INFO_PATH=None,
                 MAX_SYM_DISC_STEP: float = 0.01, DATA_PRESET: Optional[Dict] = None,
                 device=None, **_):
        if not USE_MSSD:
            raise NotImplementedError("only MSSD-based AR is supported")
        self.device = resolve_device(device)
        self.mssd_use_corners, self.use_ho3d_ycb = bool(MSSD_USE_CORNERS), bool(USE_HO3D_YCB)
        self.use_mspd, self.use_vsd = bool(USE_MSPD), bool(USE_VSD)
        self.vsd_res, self.vsd_dilate = int(VSD_RES), int(VSD_DILATE)
        self.image_width = float(((DATA_PRESET or {}).get("IMAGE_SIZE") or [224, 224])[0])
        info = load_model_info(MODEL_INFO_PATH or None)
        self.syms = SymTable(info, MAX_SYM_DISC_STEP)
        self.n_obj = self.syms.n_obj
        # the recall thresholds' diameters in metres (models_info holds mm)
        if "diameter" in info.get("1", {}):
            self.diameters = np.array([info[str(i)]["diameter"] / 1000.0
                                       for i in range(1, self.n_obj + 1)], np.float32)
        else:
            self.diameters = np.full((self.n_obj,), 0.2, np.float32)
        self._tau_grid = torch.linspace(0.05, 0.5, N_THRESHOLDS, device=self.device)
        self._diam = torch.from_numpy(self.diameters).to(self.device)
        self.ones_pad = OnesPad()
        self.reset()

    def reset(self):
        self._chunks: List[tuple] = []

    def feed(self, preds: Dict, targs: Dict):
        obj_idx = targs[Queries.OBJ_IDX].long()
        if Queries.SAMPLE_VALID in targs:
            obj_idx = torch.where(targs[Queries.SAMPLE_VALID] > 0, obj_idx, -1)
        obj_can = targs[Queries.CORNERS_CAN if self.mssd_use_corners
                        else Queries.OBJ_VERTS_CAN].float()
        pad = targs.get(Queries.PADDING_MASK)
        if pad is None or self.mssd_use_corners:
            pad = self.ones_pad(obj_can)
        gather = torch.clamp_min(obj_idx - 1, 0)
        sym = self.syms.gather(gather)
        rot = preds["box_rot_rotmat"].float()
        tsl = preds["boxroot_3d_abs"].float().reshape(-1, 1, 3)
        transf = targs[Queries.OBJ_TRANSF].float()
        vals_m = mssd_values(rot, tsl, obj_can, pad, transf, *sym, self.use_ho3d_ycb)
        has_intr = Queries.CAM_INTR in targs
        if self.use_mspd and has_intr:
            vals_px = mspd_values(rot, tsl, obj_can, pad, transf, targs[Queries.CAM_INTR].float(),
                                  *sym, self.use_ho3d_ycb)
        else:
            vals_px = torch.full_like(vals_m, float("nan"))
        if self.use_vsd and has_intr:
            # VSD splats the vertex cloud (corners make no surface); the
            # taus are (0.05..0.5) x the object's diameter (BOP19)
            vsd_can = targs.get(Queries.OBJ_VERTS_CAN, obj_can).float()
            vsd_pad = targs.get(Queries.PADDING_MASK)
            if vsd_pad is None:
                vsd_pad = torch.ones(vsd_can.shape[:2], dtype=torch.float32,
                                     device=vsd_can.device)
            taus = self._diam[gather][:, None] * self._tau_grid[None]
            vals_vsd = vsd_values(rot, tsl, vsd_can, vsd_pad, transf,
                                  targs[Queries.CAM_INTR].float(), taus, self.image_width,
                                  res=self.vsd_res, dilate=self.vsd_dilate)
        else:
            vals_vsd = torch.full((vals_m.shape[0], N_THRESHOLDS), float("nan"),
                                  dtype=vals_m.dtype, device=vals_m.device)
        self._chunks.append((vals_m, vals_px, vals_vsd, obj_idx))

    def all_reduce(self):
        """Every rank's per-sample errors, gathered (once, after a pass)."""
        if self._chunks:
            self._chunks = [tuple(all_gather_rows(torch.cat(c)) for c in zip(*self._chunks))]

    def _collect(self):
        """-> (errors (N,), errors_px (N,), errors_vsd (N, 10), obj_idx (N,))
        as numpy, the padded rows dropped."""
        if not self._chunks:
            z = np.zeros((0,), np.float32)
            return z, z, np.zeros((0, N_THRESHOLDS), np.float32), np.zeros((0,), np.int64)
        cols = [torch.cat(c).cpu().numpy() for c in zip(*self._chunks)]
        keep = cols[3] >= 0
        return tuple(c[keep] for c in cols)

    @property
    def avg(self) -> float:
        errors = self._collect()[0]
        return float(errors.sum()) / max(errors.size, 1) * 1000.0

    def get_measures(self) -> Dict[str, float]:
        errors, errors_px, errors_vsd, obj = self._collect()
        measures = {"MSSD": float(errors.sum()) / max(errors.size, 1) * 1000.0}
        for idx in range(1, self.n_obj + 1):
            e = errors[obj == idx]
            if e.size:
                measures[f"MSSD_obj_{idx}"] = float(e.mean()) * 1000.0
        if not errors.size:
            return measures
        thetas = np.linspace(0.05, 0.5, N_THRESHOLDS)
        diam = self.diameters[obj - 1]
        measures["AR_MSSD"] = float(np.mean([(errors < th * diam).mean() for th in thetas]))
        has_px = np.isfinite(errors_px)
        if has_px.any():
            px = errors_px[has_px]
            measures["MSPD"] = float(px.mean())
            rs = np.linspace(5, 50, N_THRESHOLDS) * (self.image_width / 640.0)
            measures["AR_MSPD"] = float(np.mean([(px < r).mean() for r in rs]))
            measures["AR_BOP2"] = float((measures["AR_MSSD"] + measures["AR_MSPD"]) / 2.0)
        has_vsd = np.isfinite(errors_vsd).all(axis=1)
        if has_vsd.any():
            e = errors_vsd[has_vsd]
            measures["VSD"] = float(e.mean())
            measures["AR_VSD"] = float((e[:, :, None] < thetas[None, None, :]).mean())
            if "AR_MSPD" in measures:
                measures["AR_BOP"] = float(np.mean([measures["AR_VSD"], measures["AR_MSSD"],
                                                    measures["AR_MSPD"]]))
        return measures

    def __str__(self) -> str:
        return f"mssd: {self.avg:6.4f}mm"
