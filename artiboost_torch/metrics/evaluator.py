"""Evaluator: fan-out feed to a metric list (counterpart of
``artiboost_tpu/metrics/evaluator.py``). Ported metrics: LossesMetric,
Mean3DEPE and the per-triplet ValMetricMean3DEPE2; other configured
types are skipped with a warning until they are ported."""
from __future__ import annotations

from typing import Dict, List

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.metrics.lossesmetric import LossesMetric
from artiboost_torch.metrics.meanepe import Mean3DEPE
from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
from artiboost_torch.utils.misc import logger, resolve_device

METRICS = {"LossesMetric": LossesMetric, "Mean3DEPE": Mean3DEPE,
           "ValMetricMean3DEPE2": ValMetricMean3DEPE2}


class Evaluator:
    def __init__(self, metrics_list: List):
        self.metrics_list = metrics_list

    def reset_all(self):
        for metric in self.metrics_list:
            metric.reset()

    def feed_all(self, preds: Dict, targs: Dict, losses: Dict):
        """LossesMetric takes the losses weighted by the batch's sample
        count (the valid count of a padded eval batch); the others take
        preds and targets."""
        batch_size = int(preds[next(iter(preds))].shape[0])
        if Queries.SAMPLE_VALID in targs:
            batch_size = int(targs[Queries.SAMPLE_VALID].sum())
        for metric in self.metrics_list:
            if isinstance(metric, LossesMetric):
                metric.feed(losses, batch_size=batch_size)
            else:
                metric.feed(preds=preds, targs=targs)

    def get_measures_all(self) -> Dict[str, Dict]:
        return {type(m).__name__: m.get_measures() for m in self.metrics_list
                if hasattr(m, "get_measures")}

    def __str__(self) -> str:
        return " | ".join(s for s in (str(m) for m in self.metrics_list
                                      if not isinstance(m, ValMetricMean3DEPE2)) if s)


def build_evaluator(metric_cfg_list: List[Dict], device=None) -> Evaluator:
    device = resolve_device(device)
    metrics = []
    for c in metric_cfg_list:
        c = dict(c)
        kind = c.pop("TYPE")
        if kind not in METRICS:
            logger.warning(f"metric {kind} is not ported yet; skipped")
            continue
        metrics.append(METRICS[kind](device=device, **c))
    return Evaluator(metrics)
