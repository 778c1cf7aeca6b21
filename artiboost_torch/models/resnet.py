"""ResNet backbones (counterpart of ``artiboost_tpu/models/resnet.py``;
reference ``anakin/models/resnet.py:199-274``), torchvision naming,
NCHW inside. Returns ``res_layer1..4`` and ``res_layer4_mean``."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(nn.Conv2d(cin, width, 1, stride, bias=False),
                                            nn.BatchNorm2d(width, eps=1e-5))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        out = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=1e-5)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(nn.Conv2d(cin, out, 1, stride, bias=False),
                                            nn.BatchNorm2d(out, eps=1e-5))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(self.bn3(self.conv3(y)) + idn)


class ResNet(nn.Module):
    def __init__(self, block, stage_sizes: Sequence[int]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for i, (w, n) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, w, 2 if (i > 0 and j == 0) else 1))
                cin = w * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, image_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(image_nchw)))
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


def build_resnet(cfg: Dict) -> ResNet:
    block, sizes = RESNETS[cfg["TYPE"]]
    return ResNet(block, sizes)
