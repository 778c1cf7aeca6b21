"""Per-CCV-triplet validation metric driving the mining reweight
(counterpart of ``artiboost_tpu/metrics/val_metric.py``; reference
``anakin/metrics/val_metric.py:55-144``): a dense (O, V, G) (sum, count)
pair updated by one scatter-add per batch on the device."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from artiboost_torch.datasets.hoquery import Queries, SynthQueries
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

    def averaged(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (avg_map, seen_mask)."""
        seen = self.count_map > 0
        return self.sum_map / torch.clamp_min(self.count_map, 1.0), seen


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
