"""Evaluator: fan-out feed to a metric list (counterpart of
``artiboost_tpu/metrics/evaluator.py``). Ported metrics: the
per-triplet ``ValMetricMean3DEPE2``; other configured types are skipped
with a warning until they are ported."""
from __future__ import annotations

from typing import Dict, List

from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
from artiboost_torch.utils.misc import logger, resolve_device

METRICS = {"ValMetricMean3DEPE2": ValMetricMean3DEPE2}


class Evaluator:
    def __init__(self, metrics_list: List):
        self.metrics_list = metrics_list

    def reset_all(self):
        for metric in self.metrics_list:
            metric.reset()

    def feed_all(self, preds: Dict, targs: Dict):
        for metric in self.metrics_list:
            metric.feed(preds=preds, targs=targs)


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
