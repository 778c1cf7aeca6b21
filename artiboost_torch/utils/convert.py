"""Flax variables -> torch state dict for HybridBaseline: the inverse of
``artiboost_tpu/utils/torch_convert.py``. Convs HWIO -> OIHW, the
ConvTranspose spatial flip undone (flax runs the transposed conv as an
unflipped correlation), dense kernels transposed, BatchNorm scale/bias
plus batch_stats mean/var."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def conv_weight(k: np.ndarray) -> torch.Tensor:
    """flax Conv HWIO -> torch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def deconv_weight(k: np.ndarray) -> torch.Tensor:
    """flax ConvTranspose HWIO (spatially flipped) -> torch (in, out, kH, kW)."""
    k = np.asarray(k)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))


def _bn(sd: Dict, prefix: str, p: Dict, s: Dict):
    sd[prefix + ".weight"] = torch.from_numpy(np.asarray(p["scale"]).copy())
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())
    sd[prefix + ".running_mean"] = torch.from_numpy(np.asarray(s["mean"]).copy())
    sd[prefix + ".running_var"] = torch.from_numpy(np.asarray(s["var"]).copy())
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _resnet(sd: Dict, params: Dict, stats: Dict, prefix: str = "backbone."):
    sd[prefix + "conv1.weight"] = conv_weight(params["conv1"]["kernel"])
    _bn(sd, prefix + "bn1", params["bn1"], stats["bn1"])
    for scope, blk in params.items():
        if not scope.startswith("layer"):
            continue
        li, bi = scope[len("layer"):].split("_")
        tp = f"{prefix}layer{li}.{bi}."
        n_conv = sum(1 for k in blk if k.startswith("Conv_"))
        # a Bottleneck opens with a 1x1 conv, a BasicBlock with a 3x3
        n_main = 3 if tuple(np.shape(blk["Conv_0"]["kernel"])[:2]) == (1, 1) else 2
        for c in range(n_main):
            sd[tp + f"conv{c + 1}.weight"] = conv_weight(blk[f"Conv_{c}"]["kernel"])
            _bn(sd, tp + f"bn{c + 1}", blk[f"BatchNorm_{c}"], stats[scope][f"BatchNorm_{c}"])
        if n_conv > n_main:
            sd[tp + "downsample.0.weight"] = conv_weight(blk[f"Conv_{n_main}"]["kernel"])
            _bn(sd, tp + "downsample.1", blk[f"BatchNorm_{n_main}"],
                stats[scope][f"BatchNorm_{n_main}"])


def hybrid_baseline_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """{"params": {backbone, hybrid_head, box_head}, "batch_stats": {...}}
    (numpy leaves, HybridBaseline level) -> state dict of
    ``artiboost_torch.models.hybrid_baseline.HybridBaseline``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], stats["backbone"])

    head, head_s = params["hybrid_head"], stats["hybrid_head"]
    n_deconv = sum(1 for k in head if k.startswith("ConvTranspose_"))
    for i in range(n_deconv):
        ct = head[f"ConvTranspose_{i}"]
        sd[f"hybrid_head.deconv_layers.{3 * i}.weight"] = deconv_weight(ct["kernel"])
        if "bias" in ct:
            sd[f"hybrid_head.deconv_layers.{3 * i}.bias"] = torch.from_numpy(np.asarray(ct["bias"]).copy())
        _bn(sd, f"hybrid_head.deconv_layers.{3 * i + 1}", head[f"BatchNorm_{i}"],
            head_s[f"BatchNorm_{i}"])
    sd["hybrid_head.final_layer.weight"] = conv_weight(head["Conv_0"]["kernel"])
    sd["hybrid_head.final_layer.bias"] = torch.from_numpy(np.asarray(head["Conv_0"]["bias"]).copy())

    box = params["box_head"]
    for i in range(sum(1 for k in box if k.startswith("Dense_"))):
        d = box[f"Dense_{i}"]
        sd[f"box_head.layers.{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(d["kernel"]).T))
        sd[f"box_head.layers.{2 * i}.bias"] = torch.from_numpy(np.asarray(d["bias"]).copy())
    return sd
