"""First-batch visualisation metric (counterpart of
``artiboost_tpu/metrics/vismetric.py``; reference
``anakin/metrics/vismetric.py:70-137``): the predicted skeleton and corner
cube drawn over a grid of de-normalised images, for the recorder. The
drawing is the JAX package's PIL code. Only the first batch of an epoch is
drawn: its images are de-normalised on the device by the JAX package's
float32 arithmetic (a bfloat16 image widened to float32 first, as numpy
widens it there), so both land on the same uint8 values, and only those
cross to the host."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image, ImageDraw

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.utils.misc import CONST
from artiboost_torch.utils.registry import METRIC

_FINGER_COLORS = ["#ff0000", "#00ff00", "#0000ff", "#ffff00", "#ff00ff"]


def _draw_skeleton(draw: ImageDraw.ImageDraw, kps: np.ndarray, offset, scale=1.0):
    parents = CONST.JOINTS_IDX_PARENTS
    for i in range(1, 21):
        p = parents[i]
        color = _FINGER_COLORS[(i - 1) // 4]
        draw.line(
            [
                (offset[0] + kps[p, 0] * scale, offset[1] + kps[p, 1] * scale),
                (offset[0] + kps[i, 0] * scale, offset[1] + kps[i, 1] * scale),
            ],
            fill=color, width=1,
        )


def _draw_corners(draw: ImageDraw.ImageDraw, corners: np.ndarray, offset,
                  color="#00ffff", link_order=None):
    if link_order is not None:
        # CORNER_LINK_ORDER: a polyline through the corner ids (datasets whose
        # canonical corner order differs from the default cube wiring)
        pairs = list(zip(link_order[:-1], link_order[1:]))
    else:
        pairs = CONST.CORNERCUBE_IDX_ORDER
    for a, b in pairs:
        draw.line(
            [
                (offset[0] + corners[a, 0], offset[1] + corners[a, 1]),
                (offset[0] + corners[b, 0], offset[1] + corners[b, 1]),
            ],
            fill=color, width=1,
        )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class VisMetric:
    """Base marker class (the evaluator skips these in its measures)."""

    def __init__(self, **_):
        self.images: Optional[Image.Image] = None


@METRIC.register_module
class Vis2DMetric(VisMetric):
    def __init__(self, **cfg) -> None:
        super().__init__(**cfg)
        self.ncol = cfg.get("NCOL", 4)
        self.nrow = cfg.get("NROW", 4)
        self.mean = cfg.get("MEAN", 0.5)
        self.std = cfg.get("STD", 1.0)
        self.corner_link_order = cfg.get("CORNER_LINK_ORDER")
        self.reset()

    def reset(self):
        self.images = None
        self.count = 0

    def feed(self, preds: Dict, targs: Dict, **_):
        if self.images is not None:  # only first batch per epoch
            return
        n = min(self.ncol * self.nrow, int(targs[Queries.IMAGE].shape[0]))
        image = targs[Queries.IMAGE][:n].detach().float()  # (n, H, W, 3) normalized
        std, mean = (torch.as_tensor(v, dtype=torch.float32, device=image.device)
                     for v in (self.std, self.mean))
        # the JAX package's float32 numpy ops, one rounding each, on the
        # device: only the uint8 tiles cross to the host
        tiles = ((image * std + mean) * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        H, W = tiles.shape[1], tiles.shape[2]
        intr = _host(targs[Queries.CAM_INTR][:n])
        joints_2d_uvd = preds.get("2d_uvd")
        if joints_2d_uvd is not None:
            joints_2d_uvd = _host(joints_2d_uvd[:n])
        corners_abs = _host(preds["corners_3d_abs"][:n]) if "corners_3d_abs" in preds else None
        grid = Image.new("RGB", (self.ncol * W, self.nrow * H))
        for i in range(n):
            tile = Image.fromarray(tiles[i])
            draw = ImageDraw.Draw(tile)
            if joints_2d_uvd is not None:
                kps = joints_2d_uvd[i, :21, :2] * [W, H]
                _draw_skeleton(draw, kps, (0, 0))
            if corners_abs is not None:
                hom = intr[i] @ corners_abs[i].T
                c2d = (hom[:2] / np.maximum(hom[2:], 1e-8)).T
                _draw_corners(draw, c2d, (0, 0), link_order=self.corner_link_order)
            grid.paste(tile, ((i % self.ncol) * W, (i // self.ncol) * H))
        self.images = grid
        self.count += n

    def get_measures(self, **_) -> Dict:
        return {}

    def __str__(self):
        return "vis2d"


@METRIC.register_module
class VisHand2DMetric(Vis2DMetric):
    """Hand-only overlay variant (reference ``anakin/metrics/vismetric.py:360``),
    for hand-only models with no corner predictions."""

    def __init__(self, **cfg):
        super().__init__(**cfg)
        self.corner_link_order = None

    def feed(self, preds, targs, **kwargs):
        preds = {k: v for k, v in preds.items() if k != "corners_3d_abs"}
        super().feed(preds, targs, **kwargs)
