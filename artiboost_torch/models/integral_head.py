"""Integral (soft-argmax) deconvolution pose head (counterpart of
``artiboost_tpu/models/integral_head.py``; reference
``anakin/models/simplebaseline.py:16-190``): deconv upsampling, 1x1 or
3x3 conv to NCLASSES*DEPTH channels, each class's 3D heatmap normalised
(``NORM_TYPE``: softmax, sigmoid or divide_sum), integral regression to
normalized uvd, confidence = heatmap max.

The deconvs, their BatchNorms and the final conv compute in ``dtype``
(``integral_head.py:62-74``); the normalisation and the integral are
float32 (``:80-101``)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from artiboost_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d
from artiboost_torch.utils.misc import resolve_dtype
from artiboost_torch.utils.registry import HEAD


def norm_heatmap(norm_type: str, heatmap: torch.Tensor) -> torch.Tensor:
    """heatmap (B, C, L) flattened; normalised over L (``integral_head.py:23-31``)."""
    if norm_type == "softmax":
        return torch.softmax(heatmap, dim=2)
    if norm_type == "sigmoid":
        return torch.sigmoid(heatmap)
    if norm_type == "divide_sum":
        return heatmap / heatmap.sum(dim=2, keepdim=True)
    raise NotImplementedError(norm_type)


def integral_heatmap3d(hm: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) normalised 3D heatmap -> (B, C, 3) uvd in [0, 1]
    (``integral_head.py:34-45``)."""
    d_accu, v_accu, u_accu = hm.sum(dim=(3, 4)), hm.sum(dim=(2, 4)), hm.sum(dim=(2, 3))

    def expect(accu):
        n = accu.shape[-1]
        w = torch.arange(n, dtype=hm.dtype, device=hm.device) / n
        return (accu * w).sum(dim=-1, keepdim=True)

    return torch.cat([expect(u_accu), expect(v_accu), expect(d_accu)], dim=-1)


class IntegralDeconvHead(nn.Module):
    def __init__(self, in_channels: int = 512, nclasses: int = 22, depth_res: int = 28,
                 heatmap_size: Sequence[int] = (28, 28), norm_type: str = "softmax",
                 deconv_filters: Sequence[int] = (256, 256),
                 deconv_kernels: Sequence[int] = (4, 4), deconv_with_bias: bool = False,
                 final_conv_kernel: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nclasses, self.depth_res, self.dtype = nclasses, depth_res, dtype
        self.heatmap_size, self.norm_type = tuple(heatmap_size), norm_type  # (W, H)
        layers, cin = [], in_channels
        for f, k in zip(deconv_filters, deconv_kernels):
            layers += [ConvTranspose2d(cin, f, k, bias=deconv_with_bias, compute_dtype=dtype),
                       BatchNorm2d(f, dtype), nn.ReLU()]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = Conv2d(cin, nclasses * depth_res, final_conv_kernel, 1, pad,
                                  compute_dtype=dtype)

    def forward(self, feature: torch.Tensor) -> Dict[str, torch.Tensor]:
        """feature (B, C, h, w) -> {"kp3d": (B, NC, 3) uvd, "kp3d_confd": (B, NC)}."""
        x = self.final_layer(self.deconv_layers(feature.to(self.dtype))).float()
        B, _, H, W = x.shape
        if self.norm_type != "softmax":
            return self._generic(x)
        x = x.reshape(B, self.nclasses, self.depth_res, H, W)
        m = x.amax(dim=(2, 3, 4), keepdim=True)
        e = torch.exp(x - m)
        z = e.sum(dim=(2, 3, 4))
        wd = torch.arange(self.depth_res, dtype=torch.float32, device=x.device) / self.depth_res
        wv = torch.arange(H, dtype=torch.float32, device=x.device) / H
        wu = torch.arange(W, dtype=torch.float32, device=x.device) / W
        d_ = torch.einsum("bcdhw,d->bc", e, wd) / z
        v_ = torch.einsum("bcdhw,h->bc", e, wv) / z
        u_ = torch.einsum("bcdhw,w->bc", e, wu) / z
        # max(softmax) = exp(0) / Z
        return {"kp3d": torch.stack([u_, v_, d_], dim=-1), "kp3d_confd": 1.0 / z}

    def _generic(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``integral_head.py:93-101`` (sigmoid, divide_sum): x float32
        (B, NC*D, H, W), channel c*D + d; the 3D map is read back at
        HEATMAP_SIZE, which must hold D*H*W values as JAX's reshape needs."""
        B = x.shape[0]
        flat = norm_heatmap(self.norm_type, x.reshape(B, self.nclasses, -1))
        confd = flat.amax(dim=-1)
        flat = flat / (flat.sum(dim=-1, keepdim=True) + 1e-7)
        hm3d = flat.reshape(B, self.nclasses, self.depth_res, self.heatmap_size[1],
                            self.heatmap_size[0])
        return {"kp3d": integral_heatmap3d(hm3d), "kp3d_confd": confd}


@HEAD.register_module(name="IntegralDeconvHead")
def build_integral_deconv_head(**h) -> IntegralDeconvHead:
    """The HEAD registry's ``IntegralDeconvHead`` (``integral_head.py:104-116``).
    ``INPUT_CHANNEL`` is the backbone's width (the arch's builders give it
    as a default; flax infers it); ``HEATMAP_SIZE`` (W, H) comes from the
    DATA_PRESET under the head's own keys, as in JAX."""
    return IntegralDeconvHead(
        in_channels=h.get("INPUT_CHANNEL", 512),
        nclasses=h.get("NCLASSES", 22), depth_res=h.get("DEPTH_RESOLUTION", 28),
        heatmap_size=tuple(h.get("HEATMAP_SIZE", (28, 28))),
        norm_type=h.get("NORM_TYPE", "softmax"),
        deconv_filters=tuple(h.get("NUM_DECONV_FILTERS", (256, 256))),
        deconv_kernels=tuple(h.get("NUM_DECONV_KERNELS", (4, 4))),
        deconv_with_bias=h.get("DECONV_WITH_BIAS", False),
        final_conv_kernel=h.get("FINAL_CONV_KERNEL", 1), dtype=resolve_dtype(h.get("DTYPE")))
