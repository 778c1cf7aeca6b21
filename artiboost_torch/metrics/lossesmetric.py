"""Running averages of the loss dict (counterpart of
``artiboost_tpu/metrics/lossesmetric.py``; reference
``anakin/metrics/lossesmetric.py``). The sums stay on the device; values
reach the host only in ``get_measures`` and ``__str__``."""
from __future__ import annotations

from typing import Dict, List

import torch

from artiboost_torch.metrics.metric import AverageMeter
from artiboost_torch.parallel.mesh import all_reduce_sum_


class LossesMetric:
    def __init__(self, VIS_LOSS_KEYS: List[str] = (), **_) -> None:
        self.vis_loss_keys = list(VIS_LOSS_KEYS or [])
        self.reset()

    def reset(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}

    def feed(self, losses: Dict[str, torch.Tensor], batch_size: float = 1, **_):
        """Each loss weighted by ``batch_size`` samples (under a process
        group, the global batch's count over the world: the sums over ranks
        then weight the mean of the ranks' losses by the global count)."""
        for k, v in losses.items():
            if v is None:
                continue
            v = v.detach().float() * float(batch_size)
            self.sums[k] = self.sums[k] + v if k in self.sums else v
            self.counts[k] = self.counts.get(k, 0) + batch_size

    def all_reduce(self):
        """The sums and counts of every rank, summed (once, after a pass)."""
        if not self.sums:
            return
        keys = sorted(self.sums)
        buf = torch.stack([self.sums[k] for k in keys])
        counts = torch.tensor([float(self.counts[k]) for k in keys], device=buf.device)
        buf = all_reduce_sum_(torch.cat([buf, counts]))
        self.sums = dict(zip(keys, buf[:len(keys)]))
        self.counts = dict(zip(keys, buf[len(keys):].tolist()))

    def meters(self) -> Dict[str, AverageMeter]:
        if not self.sums:
            return {}
        keys = list(self.sums)
        vals = torch.stack([self.sums[k] for k in keys]).cpu().tolist()
        out = {}
        for k, v in zip(keys, vals):
            out[k] = AverageMeter()
            out[k].update(v, n=self.counts[k])
        return out

    def get_measures(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters().items()}

    def __str__(self) -> str:
        meters = self.meters()
        if "final_loss" not in meters:
            return "no losses"
        parts = [f"final_loss: {meters['final_loss'].avg:.5f}"]
        parts += [f"{k}: {m.avg:.5f}" for k, m in meters.items() if k in self.vis_loss_keys]
        return ", ".join(parts)
