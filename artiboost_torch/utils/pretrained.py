"""Pretrained weights for the Arch models (counterpart of
``artiboost_tpu/utils/pretrained.py`` and ``torch_convert.py``).

Two kinds, loaded in the reference's order (``hybridbaseline.py:23-33``):
first ``ARCH.BACKBONE.PRETRAINED`` (``true``: torchvision ImageNet weights
found under ``checkpoints/imagenet/`` of the working directory, then of the
repository, then ``~/.cache/torch/hub/checkpoints``; or a path), then a
full released checkpoint ``ARCH.PRETRAINED`` (a ``.pth.tar``), which
overrides the backbone. The port's models already use the reference's
module names where the reference has them (ResNet as torchvision names it,
HybridBaseline and SimpleBaseline whole), so loading is a renaming of
prefixes and heads (``_REFERENCE_NAMES``: HOPRegNet's and HoNet's ``base_net``,
ManoBranch and TransHeads, and HoNet's HASSON-era names) and a cast to the
parameter's dtype. Every tensor of the model must be in the file with its
shape, or the load raises; tensors the model has no place for (the
classifier ``fc``, MANO buffers) are skipped. A file that is not found
leaves the initialisation as it is, with a warning, as in JAX."""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import torch

from artiboost_torch.utils.misc import logger

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# torchvision weight-file basenames per backbone TYPE
_IMAGENET_GLOBS = {
    "ResNet18": ("resnet18*.pth", "resnet18*.pt"),
    "ResNet34": ("resnet34*.pth", "resnet34*.pt"),
    "ResNet50": ("resnet50*.pth", "resnet50*.pt"),
    "ResNet101": ("resnet101*.pth", "resnet101*.pt"),
    "ResNet152": ("resnet152*.pth", "resnet152*.pt"),
}

_MANO_BRANCH = ((r"^mano_branch\.base_layer\.0\.", "mano_branch.fc1."),
                (r"^mano_branch\.base_layer\.2\.", "mano_branch.fc2."),
                (r"^mano_branch\.pose_reg\.", "mano_branch.pose."),
                (r"^mano_branch\.shape_reg\.(0\.)?", "mano_branch.shape."))
# reference state-dict names -> the port's, per ARCH TYPE (regex, replacement)
_REFERENCE_NAMES = {
    "HybridBaseline": (),
    "SimpleBaseline": (),
    "HOPRegNet": ((r"^base_net\.", "backbone."),) + _MANO_BRANCH + (
        (r"^obj_transfhead\.decoder\.0\.", "obj_transfhead.fc1."),
        (r"^obj_transfhead\.final_layer\.", "obj_transfhead.fc2.")),
    # HASSON[CVPR2020] checkpoints (honetMANO.py:78-111) first
    "HoNet": ((r"^scaletrans_branch_obj\.", "obj_transhead."),
              (r"^scaletrans_branch\.", "mano_transhead."),
              (r"^mano_layer_right\.", "mano_layer."),
              (r"^base_net\.", "backbone."),) + _MANO_BRANCH + (
        (r"^(mano|obj)_transhead\.decoder\.0\.", r"\1_transhead.fc1."),
        (r"^(mano|obj)_transhead\.final_layer\.", r"\1_transhead.fc2.")),
}


def resolve_path(path: str) -> Optional[str]:
    """``path`` from the working directory, else under the repository."""
    for cand in (path, os.path.join(_REPO_ROOT, path)):
        if os.path.exists(cand):
            return cand
    return None


def find_imagenet_weights(backbone_type: str, hint) -> Optional[str]:
    """``hint`` is BACKBONE.PRETRAINED: a path, or ``true`` to search."""
    if isinstance(hint, str):
        return resolve_path(hint)
    roots = (os.path.join(os.getcwd(), "checkpoints", "imagenet"),
             os.path.join(_REPO_ROOT, "checkpoints", "imagenet"),
             os.path.expanduser("~/.cache/torch/hub/checkpoints"))
    for root in roots:
        for g in _IMAGENET_GLOBS.get(backbone_type, ()):
            hits = sorted(glob.glob(os.path.join(root, g)))
            if hits:
                return hits[0]
    return None


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint -> its tensors, ``state_dict`` unwrapped and the
    ``module.`` (DataParallel) prefix stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return {(k[7:] if k.startswith("module.") else k): torch.as_tensor(v)
            for k, v in blob.items()}


def to_port_names(sd: Dict[str, torch.Tensor], model_type: str) -> Dict[str, torch.Tensor]:
    """A reference-named state dict -> the port's names for ``model_type``;
    HoNet drops the left hand's MANO buffers first."""
    rules = _REFERENCE_NAMES.get(model_type, ())
    out = {}
    for k, v in sd.items():
        if model_type == "HoNet" and "mano_layer_left" in k:
            continue
        for pattern, repl in rules:
            k = re.sub(pattern, repl, k)
        out[k] = v
    return out


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor], prefix: str = "",
              scope: str = "") -> int:
    """Copy ``sd`` into every tensor of ``module`` whose name starts with
    ``prefix`` (BatchNorm's ``num_batches_tracked`` aside), cast to the
    tensor's dtype. Raises KeyError for a tensor the file lacks and
    ValueError on a shape mismatch. -> the number copied."""
    own = {k: v for k, v in module.state_dict().items()
           if k.startswith(prefix) and not k.endswith("num_batches_tracked")}
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"pretrained {scope}: the file lacks {missing[:5]} "
                       f"({len(missing)} of {len(own)} tensors)")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"pretrained {scope}/{k} shape {tuple(sd[k].shape)} != model "
                             f"shape {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(sd[k].to(v.dtype))
    return len(own)


def load_backbone_imagenet(model: torch.nn.Module, model_cfg: Dict) -> bool:
    """``BACKBONE.PRETRAINED`` of one model entry."""
    bb_cfg = model_cfg.get("BACKBONE") or {}
    hint = bb_cfg.get("PRETRAINED")
    if not hint:
        return False
    bb_type = bb_cfg.get("TYPE", "")
    path = find_imagenet_weights(bb_type, hint)
    if path is None:
        logger.warning(f"BACKBONE.PRETRAINED={hint!r} for {bb_type}: no local ImageNet "
                       "weights found (checkpoints/imagenet/, torch hub cache) — keeping "
                       "scratch init")
        return False
    sd = {"backbone." + k: v for k, v in load_torch_state_dict(path).items()}
    n = load_into(model, sd, "backbone.", f"{model_cfg.get('TYPE')}/backbone")
    logger.info(f"loaded ImageNet {bb_type} backbone weights from {path} ({n} tensors)")
    return True


def load_model_checkpoint(model: torch.nn.Module, model_cfg: Dict) -> bool:
    """A full released ``PRETRAINED`` checkpoint of one model entry."""
    path = model_cfg.get("PRETRAINED")
    if not path or not isinstance(path, str):
        return False
    rpath = resolve_path(path)
    if rpath is None:
        logger.warning(f"ARCH.PRETRAINED={path!r} not found on disk — keeping current init")
        return False
    mtype = model_cfg.get("TYPE", "")
    if mtype not in _REFERENCE_NAMES:
        logger.warning(f"no torch-checkpoint naming for model TYPE {mtype!r}; keeping "
                       "current init")
        return False
    n = load_into(model, to_port_names(load_torch_state_dict(rpath), mtype), scope=mtype)
    logger.info(f"loaded released checkpoint {rpath} into {mtype} ({n} tensors)")
    return True


def load_arch_pretrained(arch, arch_cfg) -> bool:
    """Every PRETRAINED directive of ``arch_cfg`` (a dict or a list, one per
    model of ``arch.model_list``), backbone first. -> whether any loaded."""
    cfgs = arch_cfg if isinstance(arch_cfg, list) else [arch_cfg]
    loaded = False
    for model, c in zip(arch.model_list, cfgs):
        loaded |= load_backbone_imagenet(model, c)
        loaded |= load_model_checkpoint(model, c)
    return loaded
