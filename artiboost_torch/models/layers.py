"""Layers with flax's mixed-precision semantics (``ARCH.DTYPE``): float32
parameters cast to the compute dtype at use, activations in the compute
dtype between layers. Each class keeps the state-dict names of the torch
layer it extends and maps to the flax layer named in its docstring
(``artiboost_tpu/models/resnet.py``, ``integral_head.py``, ``mlp.py``)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from artiboost_torch.parallel import mesh

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


def same_transpose_pads(k: int, s: int = 2):
    """``lax.conv_transpose``'s "SAME" padding of the stride-dilated input:
    (leading, trailing) rows, ``k + s - 2`` in all; an odd kernel puts the
    extra row on the leading side."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(dtype=compute_dtype)`` (stride 2, any kernel,
    "SAME"), with the casts of ``Conv2d``: the output is exactly twice the
    input per side, aligned as flax aligns it. Torch's ``padding=p`` keeps
    rows ``[p, 2n - 2 + k - p)`` of the ``padding=0`` output and flax keeps
    ``[k - 1 - pad_a, k - 1 - pad_a + 2n)``, so ``p = k - 1 - pad_a``; the
    rest is one ``output_padding`` row (k = 1) or one row cropped from the
    end (odd k >= 3). Torch's usual ``padding=1, output_padding=1`` for
    k = 3 would be a one-pixel shift."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 bias: bool = False, compute_dtype: torch.dtype = torch.float32):
        pad_a, _ = same_transpose_pads(kernel_size)
        p = kernel_size - 1 - pad_a
        extra = 2 - kernel_size + 2 * p  # 2n less the padding=p output's length
        super().__init__(in_channels, out_channels, kernel_size, 2, p,
                         output_padding=max(extra, 0), bias=bias)
        self.crop = max(-extra, 0)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        y = F.conv_transpose2d(x.to(d), self.weight.to(d), bias, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        if self.crop:
            y = y[..., :y.shape[-2] - self.crop, :y.shape[-1] - self.crop]
        return y


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=compute_dtype)``, with the casts of ``Conv2d``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation over the global batch of every rank
    (flax ``nn.BatchNorm`` under a sharded jit). The forward all-reduces the
    per-channel sum, sum of squares and count and normalises with the biased
    variance; the backward all-reduces the sums of dy and dy * xhat. ``x``
    is (N, C, ...), the statistics float32; returns (y float32, the global
    mean and biased variance for the running averages)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        C = x.shape[1]
        count = torch.full((1,), float(x.numel() // C), device=x.device)
        buf = mesh.all_reduce_sum_(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]))
        n = buf[2 * C]
        mean = buf[:C] / n
        var = torch.clamp_min(buf[C:2 * C] / n - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.n, ctx.dims, ctx.shape, ctx.in_dtype = n, dims, shape, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight.view(shape) + bias.view(shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        dy = dy.float()
        sum_dy, sum_dy_xhat = dy.sum(dims), (dy * xhat).sum(dims)
        # the weight's and bias's gradients stay this rank's: the step
        # averages every parameter's gradient over ranks after backward
        glob = mesh.all_reduce_sum_(torch.cat([sum_dy, sum_dy_xhat])) / ctx.n
        C = sum_dy.shape[0]
        dx = (weight * invstd).view(shape) * (dy - glob[:C].view(shape)
                                              - xhat * glob[C:].view(shape))
        return dx.to(ctx.in_dtype), sum_dy_xhat, sum_dy, None


class _FlaxBatchNorm:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``'s training update:
    the batch statistics normalise (gradients flow through them) and the
    running averages take ``ra = 0.9 ra + 0.1 batch`` with the BIASED batch
    variance ``E[x^2] - E[x]^2``; torch's BatchNorm would fold in the
    unbiased one, which drifts the variance by n / (n - 1) every step. Under
    a process group of more than one rank the statistics are the global
    batch's (``_GlobalBatchNorm``)."""

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            self.running_mean.copy_(FLAX_BN_MOMENTUM * self.running_mean
                                    + (1.0 - FLAX_BN_MOMENTUM) * mean)
            self.running_var.copy_(FLAX_BN_MOMENTUM * self.running_var
                                   + (1.0 - FLAX_BN_MOMENTUM) * var)

    def _flax_forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        if mesh.world() > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            self._update_running(mean, var)
            return y
        with torch.no_grad():
            xf = x.float()
            dims = [0] + list(range(2, x.dim()))
            mean = xf.mean(dim=dims)
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=compute_dtype)``
    on NCHW, with flax's training update (``_FlaxBatchNorm``).

    The statistics and the normalisation are float32 and the output is
    cast to the compute dtype (flax ``_compute_stats`` promotes to float32,
    ``_normalize`` casts at the end)."""

    def __init__(self, num_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - FLAX_BN_MOMENTUM)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._flax_forward(x).to(self.compute_dtype)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on (N, C) in
    float32, with flax's training update (``_FlaxBatchNorm``); evaluation
    is ``nn.BatchNorm1d``'s."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - FLAX_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._flax_forward(x)
