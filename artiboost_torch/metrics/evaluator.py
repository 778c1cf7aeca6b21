"""Evaluator: fan-out feed to a metric list (counterpart of
``artiboost_tpu/metrics/evaluator.py``). Every metric the released and
smoke configs list is ported; a type the port does not know is skipped
with a warning."""
from __future__ import annotations

from typing import Dict, List, Optional

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.metrics.bop_ar import AR
from artiboost_torch.metrics.lossesmetric import LossesMetric
from artiboost_torch.metrics.meanepe import Mean2DEPE, Mean3DEPE
from artiboost_torch.metrics.pckmetric import (
    Hand2DPCKMetric,
    Hand3DPCKMetric,
    Obj2DPCKMetric,
    Obj3DPCKMetric,
)
from artiboost_torch.metrics.val_metric import ValMetricAR2, ValMetricMean3DEPE2
from artiboost_torch.metrics.vismetric import Vis2DMetric, VisHand2DMetric, VisMetric
from artiboost_torch.utils.misc import logger, resolve_device

METRICS = {m.__name__: m for m in (
    LossesMetric, Mean3DEPE, Mean2DEPE, ValMetricMean3DEPE2, Hand3DPCKMetric, Obj3DPCKMetric,
    Hand2DPCKMetric, Obj2DPCKMetric, Vis2DMetric, VisHand2DMetric, AR, ValMetricAR2)}


class Evaluator:
    def __init__(self, metrics_list: List):
        self.metrics_list = metrics_list

    def reset_all(self):
        for metric in self.metrics_list:
            metric.reset()

    @property
    def losses_metric(self) -> Optional[LossesMetric]:
        return next((m for m in self.metrics_list if isinstance(m, LossesMetric)), None)

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
        measures_all: Dict[str, Dict] = {}
        for metric in self.metrics_list:
            if isinstance(metric, VisMetric):
                continue
            name = type(metric).__name__
            if name in measures_all:
                logger.warning(f"duplicate metric {name}; value will be overwritten")
            measures_all[name] = metric.get_measures()
        return measures_all

    def get_measures_all_striped(self, return_losses: bool = True) -> Dict[str, Dict[str, float]]:
        """The scalar-only view, for the summarizer and the recorder's dumps."""
        out: Dict[str, Dict[str, float]] = {}
        for metric in self.metrics_list:
            if isinstance(metric, VisMetric):
                continue
            if isinstance(metric, LossesMetric) and not return_losses:
                continue
            if hasattr(metric, "get_scalar_measures"):
                # the per-triplet dicts of a ValMetric would be built only
                # to be dropped here
                scalars = dict(metric.get_scalar_measures())
            else:
                scalars = {k: float(v) for k, v in metric.get_measures().items()
                           if isinstance(v, (int, float))}
            if scalars:
                out[type(metric).__name__] = scalars
        return out

    def __str__(self) -> str:
        return " | ".join(s for s in (str(m) for m in self.metrics_list
                                      if not isinstance(m, VisMetric)) if s)


def build_evaluator(metric_cfg_list: List[Dict], data_preset: Optional[Dict] = None,
                    device=None) -> Evaluator:
    """One metric per config entry, each given ``DATA_PRESET`` when there
    is one (``evaluator.py:92-97``)."""
    device = resolve_device(device)
    metrics = []
    for c in metric_cfg_list:
        c = dict(c)
        kind = c.pop("TYPE")
        if kind not in METRICS:
            logger.warning(f"metric {kind} is not ported yet; skipped")
            continue
        if data_preset is not None:
            c.setdefault("DATA_PRESET", data_preset)
        metrics.append(METRICS[kind](device=device, **c))
    return Evaluator(metrics)
