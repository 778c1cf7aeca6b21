"""Flax variables <-> torch state dicts of the models.

``hybrid_baseline_from_flax`` is the inverse of
``artiboost_tpu/utils/torch_convert.py``: convs HWIO -> OIHW, the
ConvTranspose spatial flip undone (flax runs the transposed conv as an
unflipped correlation), dense kernels transposed, BatchNorm scale/bias
plus batch_stats mean/var. ``hybrid_baseline_to_flax`` maps torch names
and layouts back, for any subset of the state dict (parameters,
gradients, running statistics), so tests can hold the port's updated
weights, gradients and statistics against the flax trees.
``hopregnet_from_flax``, ``honet_from_flax`` and
``simple_baseline_from_flax`` do the same for the other three model
families (``FROM_FLAX`` maps an ``ARCH.TYPE`` to its converter);
``refinenet_from_flax`` loads the grasp refiner's flax params."""
from __future__ import annotations

import re
from typing import Dict, Tuple

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


def _integral_head(sd: Dict, head: Dict, head_s: Dict, prefix: str):
    n_deconv = sum(1 for k in head if k.startswith("ConvTranspose_"))
    for i in range(n_deconv):
        ct = head[f"ConvTranspose_{i}"]
        sd[f"{prefix}.deconv_layers.{3 * i}.weight"] = deconv_weight(ct["kernel"])
        if "bias" in ct:
            sd[f"{prefix}.deconv_layers.{3 * i}.bias"] = torch.from_numpy(np.asarray(ct["bias"]).copy())
        _bn(sd, f"{prefix}.deconv_layers.{3 * i + 1}", head[f"BatchNorm_{i}"],
            head_s[f"BatchNorm_{i}"])
    sd[f"{prefix}.final_layer.weight"] = conv_weight(head["Conv_0"]["kernel"])
    sd[f"{prefix}.final_layer.bias"] = torch.from_numpy(np.asarray(head["Conv_0"]["bias"]).copy())


def hybrid_baseline_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """{"params": {backbone, hybrid_head, box_head}, "batch_stats": {...}}
    (numpy leaves, HybridBaseline level) -> state dict of
    ``artiboost_torch.models.hybrid_baseline.HybridBaseline``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], stats["backbone"])
    _integral_head(sd, params["hybrid_head"], stats["hybrid_head"], "hybrid_head")

    box = params["box_head"]
    for i in range(sum(1 for k in box if k.startswith("Dense_"))):
        d = box[f"Dense_{i}"]
        sd[f"box_head.layers.{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(d["kernel"]).T))
        sd[f"box_head.layers.{2 * i}.bias"] = torch.from_numpy(np.asarray(d["bias"]).copy())
    return sd


def _dense(sd: Dict, prefix: str, p: Dict):
    """flax Dense kernel (in, out) -> nn.Linear weight (out, in)."""
    sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T))
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())


def simple_baseline_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """SimpleBaseline's flax variables ({backbone, pose_head}) -> the state
    dict of ``artiboost_torch.models.simple_baseline.SimpleBaseline``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], stats["backbone"])
    _integral_head(sd, params["pose_head"], stats["pose_head"], "pose_head")
    return sd


def _mano_branch(sd: Dict, p: Dict):
    """ManoBranch's Dense_0-1 (the MLP), Dense_2 (pose) and Dense_3 (shape,
    absent without USE_SHAPE)."""
    for i, name in enumerate(("fc1", "fc2", "pose", "shape")):
        if f"Dense_{i}" in p:
            _dense(sd, f"mano_branch.{name}", p[f"Dense_{i}"])


def _trans_head(sd: Dict, p: Dict, prefix: str):
    _dense(sd, f"{prefix}.fc1", p["Dense_0"])
    _dense(sd, f"{prefix}.fc2", p["Dense_1"])


def hopregnet_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """HOPRegNet's flax variables ({backbone, mano_branch, obj_transfhead})
    -> the state dict of ``artiboost_torch.models.hpregnet.HOPRegNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], stats["backbone"])
    _mano_branch(sd, params["mano_branch"])
    _trans_head(sd, params["obj_transfhead"], "obj_transfhead")
    return sd


def honet_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """HoNet's flax variables ({backbone, mano_branch, mano_transhead,
    obj_transhead[, adaptor]}) -> the state dict of
    ``artiboost_torch.models.honet.HoNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], stats["backbone"])
    _mano_branch(sd, params["mano_branch"])
    _trans_head(sd, params["mano_transhead"], "mano_transhead")
    _trans_head(sd, params["obj_transhead"], "obj_transhead")
    if "adaptor" in params:
        sd["adaptor.regressor"] = torch.from_numpy(np.asarray(params["adaptor"]["regressor"]).copy())
    return sd


FROM_FLAX = {"HybridBaseline": hybrid_baseline_from_flax, "HOPRegNet": hopregnet_from_flax,
             "HoNet": honet_from_flax, "SimpleBaseline": simple_baseline_from_flax}


def _layer_norm(sd: Dict, prefix: str, p: Dict):
    sd[prefix + ".weight"] = torch.from_numpy(np.asarray(p["scale"]).copy())
    sd[prefix + ".bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())


def refinenet_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """RefineNet flax params (numpy leaves, below "params") -> state dict
    of ``artiboost_torch.artiboost.refiner.RefineNet``. In ``ResBlock_k``
    the projection is ``Dense_0`` when it exists (fin != fout); the branch
    is the next two Dense layers with ``LayerNorm_0`` and ``LayerNorm_1``.
    At the top, ``LayerNorm_0`` normalises the distances, ``Dense_0`` is
    the dpose head and ``Dense_1`` the dtrans head."""
    sd: Dict[str, torch.Tensor] = {}
    _layer_norm(sd, "ln0", params["LayerNorm_0"])
    _dense(sd, "dpose", params["Dense_0"])
    _dense(sd, "dtrans", params["Dense_1"])
    for k in range(sum(1 for name in params if name.startswith("ResBlock_"))):
        blk, pre = params[f"ResBlock_{k}"], f"blocks.{k}."
        n_dense = sum(1 for name in blk if name.startswith("Dense_"))
        if n_dense == 3:
            _dense(sd, pre + "proj", blk["Dense_0"])
        _dense(sd, pre + "fc1", blk[f"Dense_{n_dense - 2}"])
        _dense(sd, pre + "fc2", blk[f"Dense_{n_dense - 1}"])
        _layer_norm(sd, pre + "ln1", blk["LayerNorm_0"])
        _layer_norm(sd, pre + "ln2", blk["LayerNorm_1"])
    return sd


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _flax_leaf(name: str, shape: Tuple[int, ...], names) -> Tuple[str, Tuple[str, ...], str]:
    """torch name -> (collection, flax path, layout) with layout one of
    "conv", "deconv", "dense", "vector"; None for num_batches_tracked."""
    *scope, leaf = name.split(".")
    if leaf == "num_batches_tracked":
        return None
    m = re.fullmatch(r"backbone\.(conv1|bn1)", ".".join(scope))
    if m:
        return _module_leaf(("backbone", m.group(1)), leaf, len(shape))
    m = re.fullmatch(r"backbone\.layer(\d+)\.(\d+)\.(conv|bn)(\d)", ".".join(scope))
    if m:
        li, bi, kind, k = m.groups()
        mod = f"{'Conv' if kind == 'conv' else 'BatchNorm'}_{int(k) - 1}"
        return _module_leaf(("backbone", f"layer{li}_{bi}", mod), leaf, len(shape))
    m = re.fullmatch(r"backbone\.layer(\d+)\.(\d+)\.downsample\.(\d)", ".".join(scope))
    if m:
        li, bi, k = m.groups()
        n_main = 3 if f"backbone.layer{li}.{bi}.conv3.weight" in names else 2
        mod = f"{'Conv' if k == '0' else 'BatchNorm'}_{n_main}"
        return _module_leaf(("backbone", f"layer{li}_{bi}", mod), leaf, len(shape))
    m = re.fullmatch(r"hybrid_head\.deconv_layers\.(\d+)", ".".join(scope))
    if m:
        i, r = divmod(int(m.group(1)), 3)
        if r == 0:
            coll, fl = ("params", "kernel") if leaf == "weight" else ("params", "bias")
            return coll, ("hybrid_head", f"ConvTranspose_{i}", fl), \
                "deconv" if leaf == "weight" else "vector"
        return _module_leaf(("hybrid_head", f"BatchNorm_{i}"), leaf, len(shape))
    if ".".join(scope) == "hybrid_head.final_layer":
        return _module_leaf(("hybrid_head", "Conv_0"), leaf, len(shape))
    m = re.fullmatch(r"box_head\.layers\.(\d+)", ".".join(scope))
    if m:
        d = int(m.group(1)) // 2
        return ("params", ("box_head", f"Dense_{d}", "kernel" if leaf == "weight" else "bias"),
                "dense" if leaf == "weight" else "vector")
    raise KeyError(f"no flax counterpart for {name}")


def _module_leaf(path: Tuple[str, ...], leaf: str, ndim: int):
    if path[-1].startswith(("bn", "BatchNorm")):
        coll, fl = _BN_LEAVES[leaf]
        return coll, path + (fl,), "vector"
    if leaf == "weight":
        return "params", path + ("kernel",), "conv" if ndim == 4 else "dense"
    return "params", path + ("bias",), "vector"


def _to_flax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    a = t.detach().float().cpu().numpy()
    if layout == "conv":  # OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if layout == "deconv":  # (in, out, kH, kW) -> flipped HWIO
        return np.ascontiguousarray(np.transpose(a, (2, 3, 0, 1))[::-1, ::-1])
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    return a


def hybrid_baseline_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """{torch name: tensor} (a HybridBaseline state dict, its gradients or
    any subset) -> {"params": tree, "batch_stats": tree} of numpy arrays in
    flax names and layouts; collections with no entry are left out."""
    out: Dict[str, Dict] = {}
    for name, t in tensors.items():
        leaf = _flax_leaf(name, tuple(t.shape), tensors)
        if leaf is None:
            continue
        coll, path, layout = leaf
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax_layout(t, layout)
    return out
