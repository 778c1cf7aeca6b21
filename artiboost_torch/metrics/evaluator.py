"""Evaluator: fan-out feed to a metric list (counterpart of
``artiboost_tpu/metrics/evaluator.py``). Every metric the released and
smoke configs list is ported; every metric builds through the METRIC
registry, and a type it does not know raises ``KeyError`` as JAX's does."""
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
from artiboost_torch.parallel import mesh
from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.registry import METRIC, build_from_cfg

# every metric, by the name the JAX package registers it under
METRICS = METRIC.module_dict
__all__ = ["AR", "Evaluator", "Hand2DPCKMetric", "Hand3DPCKMetric", "LossesMetric", "METRICS",
           "Mean2DEPE", "Mean3DEPE", "Obj2DPCKMetric", "Obj3DPCKMetric", "ValMetricAR2",
           "ValMetricMean3DEPE2", "Vis2DMetric", "VisHand2DMetric", "build_evaluator"]


class Evaluator:
    def __init__(self, metrics_list: List):
        self.metrics_list = metrics_list

    def reset_all(self):
        for metric in self.metrics_list:
            metric.reset()

    @property
    def losses_metric(self) -> Optional[LossesMetric]:
        return next((m for m in self.metrics_list if isinstance(m, LossesMetric)), None)

    def feed_all(self, preds: Dict, targs: Dict, losses: Dict, n_global: Optional[int] = None):
        """LossesMetric takes the losses weighted by the batch's sample
        count (the valid count of a padded eval batch); the others take
        preds and targets. Under a process group ``n_global`` is the global
        batch's count (default: this rank's times the world) and each rank
        weights its losses by ``n_global / world``."""
        batch_size = int(preds[next(iter(preds))].shape[0])
        with profiling.trace("metrics/feed"):
            if Queries.SAMPLE_VALID in targs:
                batch_size = int(targs[Queries.SAMPLE_VALID].sum())
            n_ranks = mesh.world()
            if n_ranks > 1:
                batch_size = (batch_size * n_ranks if n_global is None else n_global) / n_ranks
            for metric in self.metrics_list:
                if isinstance(metric, LossesMetric):
                    metric.feed(losses, batch_size=batch_size)
                else:
                    metric.feed(preds=preds, targs=targs)

    def all_reduce(self):
        """After a pass under a process group: every metric's accumulators
        reduced over ranks, so every rank reads the global figures (the
        visualisations keep this rank's first batch)."""
        if mesh.world() == 1:
            return
        for metric in self.metrics_list:
            if hasattr(metric, "all_reduce"):
                metric.all_reduce()

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
                    device=None, **extra_defaults) -> Evaluator:
    """One metric per config entry through the METRIC registry, each given
    ``DATA_PRESET`` when there is one (``evaluator.py:92-97``), the
    ``device`` and ``extra_defaults`` (the submission's ``ARG``, the
    command line); an unknown TYPE raises ``KeyError``."""
    defaults = dict(extra_defaults, device=resolve_device(device))
    if data_preset is not None:
        defaults["DATA_PRESET"] = data_preset
    return Evaluator([build_from_cfg(c, METRIC, defaults) for c in metric_cfg_list])
