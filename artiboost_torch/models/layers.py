"""Layers with flax's mixed-precision semantics (``ARCH.DTYPE``): float32
parameters cast to the compute dtype at use, activations in the compute
dtype between layers. Each class keeps the state-dict names of the torch
layer it extends and maps to the flax layer named in its docstring
(``artiboost_tpu/models/resnet.py``, ``integral_head.py``, ``mlp.py``)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

FLAX_BN_MOMENTUM = 0.9  # nn.BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 batch


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=compute_dtype)``: input, kernel and bias cast
    to the compute dtype; the output stays in it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(dtype=compute_dtype)`` (stride 2, kernel 4,
    "SAME"), with the casts of ``Conv2d``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.conv_transpose2d(x.to(d), self.weight.to(d), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=compute_dtype)``, with the casts of ``Conv2d``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=compute_dtype)``
    on NCHW.

    The statistics and the normalisation are float32 and the output is
    cast to the compute dtype (flax ``_compute_stats`` promotes to float32,
    ``_normalize`` casts at the end). In training the batch statistics
    normalise (gradients flow through them) and the running averages take
    flax's update, ``ra = 0.9 ra + 0.1 batch`` with the BIASED batch
    variance ``E[x^2] - E[x]^2``; ``nn.BatchNorm2d`` would fold in the
    unbiased one, which drifts the variance by n / (n - 1) every step."""

    def __init__(self, num_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - FLAX_BN_MOMENTUM)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
                self.running_mean.copy_(FLAX_BN_MOMENTUM * self.running_mean
                                        + (1.0 - FLAX_BN_MOMENTUM) * mean)
                self.running_var.copy_(FLAX_BN_MOMENTUM * self.running_var
                                       + (1.0 - FLAX_BN_MOMENTUM) * var)
            y = F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
        return y.to(self.compute_dtype)
