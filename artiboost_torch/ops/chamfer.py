"""Nearest-neighbour (chamfer) distances on torch tensors (counterpart of
``artiboost_tpu/ops/chamfer.py``; reference CUDA extension
``anakin/artiboost/refiner.py:21-83``).

Squared pairwise distances expand to |x|^2 + |y|^2 - 2 x.y^T, clamped at
0, the cross term one batched product. It stays float32 with TF32 off:
at the ~0.5 m camera distances of the view engine |x|^2 and |y|^2 are
~0.25 m^2, and TF32's 10-bit mantissa in the cross term would turn the
cancellation into millimetre errors."""
from __future__ import annotations

from typing import Optional

import torch


class _no_tf32:
    """Full float32 for the cross term, whatever the caller's TF32 setting."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (B, N, 3), y (B, M, 3) -> (B, N, M) squared euclidean distances."""
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    with _no_tf32():
        cross = torch.bmm(x, y.transpose(1, 2))
    return torch.clamp_min(x2[:, :, None] + y2[:, None, :] - 2.0 * cross, 0.0)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, mask_x: Optional[torch.Tensor] = None,
                     mask_y: Optional[torch.Tensor] = None, return_idx: bool = False):
    """Bidirectional squared NN distances -> (dist_xy (B, N), dist_yx (B, M)
    [, idx_xy, idx_yx]). mask_* (B, N) / (B, M): 1 = valid. A masked point
    gets distance 0 and is never selected as a neighbour (its pairs carry
    float32 max)."""
    d = pairwise_sqdist(x, y)
    big = torch.finfo(d.dtype).max
    if mask_y is not None:
        d = torch.where(mask_y[:, None, :] > 0, d, big)
    d_t = d if mask_x is None else torch.where(mask_x[:, :, None] > 0, d, big)
    dist_xy, idx_xy = torch.min(d, dim=2)
    dist_yx, idx_yx = torch.min(d_t, dim=1)
    if mask_x is not None:
        dist_xy = torch.where(mask_x > 0, dist_xy, 0.0)
    if mask_y is not None:
        dist_yx = torch.where(mask_y > 0, dist_yx, 0.0)
    if not return_idx:
        return dist_xy, dist_yx
    return dist_xy, dist_yx, idx_xy, idx_yx
