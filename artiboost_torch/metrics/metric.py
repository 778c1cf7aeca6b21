"""Running average (counterpart of ``artiboost_tpu/metrics/metric.py``;
reference ``anakin/metrics/metric.py``)."""
from __future__ import annotations


class AverageMeter:
    def __init__(self) -> None:
        self.reset()

    def reset(self):
        self.avg, self.sum, self.count = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        self.sum += val
        self.count += n
        self.avg = self.sum / max(self.count, 1)
