"""MLP_O box head (counterpart of ``artiboost_tpu/models/mlp.py``;
reference ``anakin/models/mlp.py``): LAYERS_N[0] is the input width,
hidden Linear+ReLU per following width, then OUT_CHANNEL. The layers
compute in ``dtype`` and the output is float32 (``mlp.py:20-23``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from artiboost_torch.models.layers import Linear
from artiboost_torch.utils.misc import resolve_dtype
from artiboost_torch.utils.registry import MODEL


class MLP(nn.Module):
    def __init__(self, layers_n: Sequence[int] = (512, 256, 128), out_channel: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mods, cin = [], layers_n[0]
        for width in layers_n[1:]:
            mods += [Linear(cin, width, compute_dtype=dtype), nn.ReLU()]
            cin = width
        mods.append(Linear(cin, out_channel, compute_dtype=dtype))
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x.to(self.dtype)).float()


@MODEL.register_module(name="MLP_O")
def build_mlp_o(**cfg) -> MLP:
    """The MODEL registry's ``MLP_O`` (``mlp.py:26-32``)."""
    return MLP(layers_n=tuple(cfg.get("LAYERS_N", (512, 256, 128))),
               out_channel=cfg.get("OUT_CHANNEL", 6), dtype=resolve_dtype(cfg.get("DTYPE")))
