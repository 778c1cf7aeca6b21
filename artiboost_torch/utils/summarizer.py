"""TensorBoard summarizer (counterpart of ``artiboost_tpu/utils/summarizer.py``;
reference ``anakin/utils/summarizer.py``): the same tags, written through
``torch.utils.tensorboard`` into ``<dump_path>/runs``. Losses go under
``{prefix}/loss/{key}`` at the optimizer step, an evaluator's scalar
measures under ``{split}/{Metric}/{key}`` at the epoch."""
from __future__ import annotations

import os
from typing import Dict


class Summarizer:
    def __init__(self, dump_path: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(os.path.join(dump_path, "runs"))

    def summarize_losses(self, losses: Dict, step: int, prefix: str = "train"):
        for k, v in losses.items():
            if v is not None:
                self.writer.add_scalar(f"{prefix}/loss/{k}", float(v), step)

    def summarize_evaluator(self, evaluator, epoch: int, split: str = "train"):
        for name, scalars in evaluator.get_measures_all_striped().items():
            for k, v in scalars.items():
                self.writer.add_scalar(f"{split}/{name}/{k}", float(v), epoch)
        self.writer.flush()

    def close(self):
        self.writer.close()


class NullSummarizer:
    """The summarizer of a rank other than 0: rank 0 writes the events."""

    def summarize_losses(self, *a, **k):
        pass

    def summarize_evaluator(self, *a, **k):
        pass

    def close(self):
        pass
