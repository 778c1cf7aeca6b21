"""Mean end-point error (counterpart of ``artiboost_tpu/metrics/meanepe.py``
``Mean3DEPE`` and ``Mean2DEPE``; reference ``anakin/metrics/meanepe.py``): masked
(sum, count) pairs accumulated on the device per VAL_KEY. A key ending
in ``_abs`` is held against the root-relative target plus the root; the
union-batch validity of both masks the sample, as does SAMPLE_VALID, and
the unseen-object filter drops corner samples of the listed objects: those
of ``ARG.filter_unseen_obj_idxs`` where the submission passes its command
line, else the config's FILTER_UNSEEN_OBJ_IDXS (``meanepe.py:47-52``)."""
from __future__ import annotations

from typing import Dict, List

import torch

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.metrics.metric import AverageMeter
from artiboost_torch.parallel.mesh import all_reduce_sum_
from artiboost_torch.utils.batching import key_validity
from artiboost_torch.utils.misc import resolve_device
from artiboost_torch.utils.registry import METRIC


@METRIC.register_module
class Mean3DEPE:
    def __init__(self, VAL_KEYS: List[str], MILLIMETERS: bool = False,
                 FILTER_UNSEEN_OBJ_IDXS: List[int] = (), ARG=None, device=None, **_) -> None:
        self.val_keys_list = list(VAL_KEYS)
        self.to_millimeters = bool(MILLIMETERS)
        idxs = (getattr(ARG, "filter_unseen_obj_idxs", []) if ARG is not None
                else FILTER_UNSEEN_OBJ_IDXS)
        self.filter_unseen_obj_idxs = [int(i) for i in idxs or []]
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.acc = {k: torch.zeros(2, dtype=torch.float32, device=self.device)
                    for k in self.val_keys_list}

    def feed(self, preds: Dict, targs: Dict, **_):
        for key in self.val_keys_list:
            pred = preds[key].float()
            if "_abs" in key:
                targ_key = key.replace("_abs", "")
                targ = targs[targ_key] + targs[Queries.ROOT_JOINT][:, None]
                kv = key_validity(targs, targ_key, Queries.ROOT_JOINT)
            else:
                targ = targs[key]
                kv = key_validity(targs, key)
            d = torch.linalg.norm(pred - targ.float(), dim=2).mean(dim=1)  # (B,)
            mask = torch.ones_like(d)
            if "corners" in key:
                for idx in self.filter_unseen_obj_idxs:
                    mask = mask * (targs[Queries.OBJ_IDX] != idx).float()
            if Queries.SAMPLE_VALID in targs:
                mask = mask * targs[Queries.SAMPLE_VALID].float()
            if kv is not None:
                mask = mask * kv
            self.acc[key] = self.acc[key] + torch.stack([torch.sum(d * mask), torch.sum(mask)])

    def all_reduce(self):
        """Every rank's (sum, count) pairs, summed (once, after a pass)."""
        flat = all_reduce_sum_(torch.stack([self.acc[k] for k in self.val_keys_list]))
        self.acc = dict(zip(self.val_keys_list, flat))

    def avg_meters(self) -> Dict[str, AverageMeter]:
        scale = 1000.0 if self.to_millimeters else 1.0
        flat = torch.stack([self.acc[k] for k in self.val_keys_list]).cpu().tolist()
        out = {}
        for k, (s, n) in zip(self.val_keys_list, flat):
            out[k] = AverageMeter()
            out[k].update(s * scale, n=int(round(n)))
        return out

    def get_measures(self) -> Dict[str, float]:
        return {f"{k}_mepe": m.avg for k, m in self.avg_meters().items()}

    def __str__(self) -> str:
        return " | ".join(f"{k}_mepe: {m.avg:6.4f}" for k, m in self.avg_meters().items())


@METRIC.register_module
class Mean2DEPE(Mean3DEPE):
    """Mean3DEPE over 2D keys, always in the keys' own unit (pixels)."""

    def __init__(self, **cfg) -> None:
        super().__init__(**cfg)
        self.to_millimeters = False
