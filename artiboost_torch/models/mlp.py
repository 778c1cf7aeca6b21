"""MLP_O box head (counterpart of ``artiboost_tpu/models/mlp.py``;
reference ``anakin/models/mlp.py``): LAYERS_N[0] is the input width,
hidden Linear+ReLU per following width, then OUT_CHANNEL."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, layers_n: Sequence[int] = (512, 256, 128), out_channel: int = 6):
        super().__init__()
        mods, cin = [], layers_n[0]
        for width in layers_n[1:]:
            mods += [nn.Linear(cin, width), nn.ReLU()]
            cin = width
        mods.append(nn.Linear(cin, out_channel))
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x).float()
