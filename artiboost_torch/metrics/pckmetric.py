"""PCK curves and AUC (counterpart of ``artiboost_tpu/metrics/pckmetric.py``;
reference ``anakin/metrics/pckmetric.py``).

Each feed computes its keypoint distances on the device as float32 norms
and keeps them there; ``get_measures`` folds them to the host once, after
which the curve, the AUC (``np.trapezoid``) and the ``SAMPLE_VALID``
masking follow the JAX package line for line."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.parallel.mesh import all_gather_rows
from artiboost_torch.utils.misc import CONST
from artiboost_torch.utils.registry import METRIC

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class PCKMetric:
    num_kp = 0

    def __init__(self, VAL_MIN: float, VAL_MAX: float, STEPS: int, **_) -> None:
        self.val_min, self.val_max, self.steps = VAL_MIN, VAL_MAX, STEPS
        self.reset()

    def _get_predictions(self, preds: Dict, targs: Dict):
        """-> (kp_preds (B,N,D), kp_targs (B,N,D), kp_vis (B,N))."""
        raise NotImplementedError

    def reset(self):
        self._dists: List[torch.Tensor] = []  # device chunks of (B, N)
        self._vis: List[torch.Tensor] = []
        self._host_dists: List[np.ndarray] = []
        self._host_vis: List[np.ndarray] = []
        self.count = 0

    def feed(self, preds: Dict, targs: Dict, **_):
        kp_preds, kp_targs, kp_vis = self._get_predictions(preds, targs)
        kp_vis = kp_vis.float()
        if Queries.SAMPLE_VALID in targs:
            # repeat-padded eval-tail rows count as invisible keypoints
            kp_vis = kp_vis * targs[Queries.SAMPLE_VALID].float()[:, None]
        self._dists.append(torch.linalg.norm(kp_preds.float() - kp_targs.float(), dim=-1))
        self._vis.append(kp_vis)
        self.count += int(kp_preds.shape[0])

    def _stacked(self):
        if self._dists:
            self._host_dists.append(torch.cat(self._dists).cpu().numpy())
            self._host_vis.append(torch.cat(self._vis).cpu().numpy())
            self._dists, self._vis = [], []
        return np.concatenate(self._host_dists, 0), np.concatenate(self._host_vis, 0) > 0.5

    def all_reduce(self):
        """Every rank's distances and visibilities, gathered (once, after a
        pass; the curve and the AUC do not depend on the rows' order)."""
        if not (self._dists or self._host_dists):
            return
        dists, vis = self._stacked()
        dists = all_gather_rows(torch.from_numpy(dists)).numpy()
        vis = all_gather_rows(torch.from_numpy(vis.astype(np.float32))).numpy()
        self._host_dists, self._host_vis = [dists], [vis]
        self.count = int(dists.shape[0])

    def get_measures(self) -> Dict:
        thresholds = np.linspace(self.val_min, self.val_max, self.steps)
        area_under_one = _trapezoid(np.ones_like(thresholds), thresholds)
        dists, vis = self._stacked()
        epe_mean_per_kp, auc_per_kp, pck_curve_per_kp = [], [], []
        for i in range(self.num_kp):
            d = dists[:, i][vis[:, i]]
            if d.size == 0:
                continue
            epe_mean_per_kp.append(np.mean(d))
            pck_curve = np.array([np.mean(d <= t) for t in thresholds])
            pck_curve_per_kp.append(pck_curve)
            auc_per_kp.append(_trapezoid(pck_curve, thresholds) / area_under_one)
        return {
            "epe_mean_per_kp": np.array(epe_mean_per_kp),
            "pck_curve_per_kp": np.array(pck_curve_per_kp),
            "auc_per_kp": np.array(auc_per_kp),
            "epe_mean_all": float(np.mean(epe_mean_per_kp)),
            "auc_all": float(np.mean(auc_per_kp)),
            "thresholds": thresholds,
        }

    def __str__(self):
        m = self.get_measures()
        return f"auc: {m['auc_all']:6.4f} | epe: {m['epe_mean_all']:6.4f}"


@METRIC.register_module
class Hand3DPCKMetric(PCKMetric):
    num_kp = CONST.NUM_JOINTS

    def _get_predictions(self, preds, targs):
        targ = targs[Queries.JOINTS_3D] + targs[Queries.ROOT_JOINT][:, None]
        return preds["joints_3d_abs"], targ, targs[Queries.JOINTS_VIS]


@METRIC.register_module
class Obj3DPCKMetric(PCKMetric):
    num_kp = CONST.NUM_CORNERS

    def _get_predictions(self, preds, targs):
        targ = targs[Queries.CORNERS_3D] + targs[Queries.ROOT_JOINT][:, None]
        return preds["corners_3d_abs"], targ, targs[Queries.CORNERS_VIS]


@METRIC.register_module
class Hand2DPCKMetric(PCKMetric):
    num_kp = CONST.NUM_JOINTS

    def _get_predictions(self, preds, targs):
        return preds["joints_2d"], targs[Queries.JOINTS_2D], targs[Queries.JOINTS_VIS]


@METRIC.register_module
class Obj2DPCKMetric(PCKMetric):
    num_kp = CONST.NUM_CORNERS

    def _get_predictions(self, preds, targs):
        return preds["corners_2d"], targs[Queries.CORNERS_2D], targs[Queries.CORNERS_VIS]
