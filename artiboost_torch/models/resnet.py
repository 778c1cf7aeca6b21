"""ResNet backbones (counterpart of ``artiboost_tpu/models/resnet.py``;
reference ``anakin/models/resnet.py:199-274``), torchvision naming,
NCHW inside. Returns ``res_layer1..4`` and ``res_layer4_mean``.

``dtype`` is the compute dtype of ``ARCH.DTYPE``: the image is cast to it
on entry (``resnet.py:71``) and every conv and BatchNorm computes and
returns it (``models/layers.py``), so the features come out in it."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from artiboost_torch.models.layers import BatchNorm2d, Conv2d
from artiboost_torch.utils.misc import resolve_dtype
from artiboost_torch.utils.registry import BACKBONE
from artiboost_torch.utils.registry import build_backbone as build_registered_backbone


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(
                Conv2d(cin, width, 1, stride, bias=False, compute_dtype=dtype),
                BatchNorm2d(width, dtype))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out = width * 4
        self.conv1 = Conv2d(cin, width, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype)
        self.conv3 = Conv2d(width, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = BatchNorm2d(out, dtype)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, bias=False, compute_dtype=dtype),
                BatchNorm2d(out, dtype))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idn)


class ResNet(nn.Module):
    def __init__(self, block, stage_sizes: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        cin = 64
        for i, (w, n) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, w, 2 if (i > 0 and j == 0) else 1, dtype))
                cin = w * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, image_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(image_nchw.to(self.dtype))))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        feats = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats[f"res_layer{i}"] = x
        feats["res_layer4_mean"] = x.mean(dim=(2, 3))
        return feats


RESNETS = {
    "ResNet18": (BasicBlock, (2, 2, 2, 2)),
    "ResNet34": (BasicBlock, (3, 4, 6, 3)),
    "ResNet50": (Bottleneck, (3, 4, 6, 3)),
    "ResNet101": (Bottleneck, (3, 4, 23, 3)),
    "ResNet152": (Bottleneck, (3, 8, 36, 3)),
}


def build_resnet(cfg: Dict, dtype: torch.dtype = torch.float32) -> ResNet:
    block, sizes = RESNETS[cfg["TYPE"]]
    return ResNet(block, sizes, dtype)


def _make_factory(name: str):
    """The BACKBONE registry's entry ``name``: a factory of the ResNet in the
    config's ``DTYPE`` (``resnet.py:88-95``)."""
    def factory(**cfg) -> ResNet:
        return build_resnet({"TYPE": name}, resolve_dtype(cfg.get("DTYPE")))

    factory.__name__ = name
    return BACKBONE.register_module(factory, name=name)


for _name in RESNETS:
    _make_factory(_name)


def build_backbone(arch_cfg: Dict) -> ResNet:
    """An ARCH entry's BACKBONE through the BACKBONE registry, in
    ``ARCH.DTYPE`` (the backbone's own DTYPE wins, as the JAX package's
    build functions merge them)."""
    sub = {"DTYPE": arch_cfg["DTYPE"]} if arch_cfg.get("DTYPE") else {}
    return build_registered_backbone({**sub, **arch_cfg["BACKBONE"]})
