"""The port's pretrained-weight loading (``artiboost_torch/utils/pretrained.py``)
against the JAX package's (``artiboost_tpu/utils/pretrained.py``).

* ``BACKBONE.PRETRAINED: true`` finds a torchvision-named ResNet34 file
  under ``checkpoints/imagenet/`` (written by ``datasets/layouts.py``) and
  loads it into the port's backbone bit for bit, the heads untouched.
* A reference-named ``.pth.tar`` of ``tests/test_full_parity.py``'s torch
  twins (HybridBaseline; HoNet under its HASSON-era names; HOPRegNet), read
  by the port's loader and by JAX's ``load_arch_pretrained`` into flax,
  gives the same float32 forward (eval mode, 64 x 64, batch 2) at the
  tolerances ``tests/test_torch_models_reg.py`` holds a forward to: the
  camera-space outputs within 1e-5 m, the rest rtol 1e-4 + atol 1e-4.
* A shape mismatch raises; an absent file warns and keeps the
  initialisation."""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.datasets import layouts
from artiboost_torch.models.arch import build_arch as t_build_arch
from artiboost_torch.utils.pretrained import load_arch_pretrained as t_load
from artiboost_tpu.models import build_arch as j_build_arch
from artiboost_tpu.parallel import build_optimizer, create_train_state
from artiboost_tpu.utils.pretrained import load_arch_pretrained as j_load
from tests import test_full_parity as fp
from tests.test_torch_models_reg import _hold

PRESET = {"IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [8, 8], "CENTER_IDX": 0}
MANO_HEAD = {"TYPE": "ManoBranch", "INPUT_DIM": 512, "NCOMPS": 15, "USE_PCA": True,
             "USE_SHAPE": True}


def _batch(seed=1, n=2):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, 64, 64, 3).astype(np.float32) - 0.5,
            "root_joint": np.tile([0.02, -0.03, 0.55], (n, 1)).astype(np.float32),
            "cam_intr": np.tile(np.array([[180.0, 0, 30], [0, 180.0, 33], [0, 0, 1]],
                                         np.float32), (n, 1, 1)),
            "corners_can": (rng.randn(n, 8, 3) * 0.05).astype(np.float32)}


def _save(sd, path):
    torch.save({"state_dict": {k: v for k, v in sd.items()
                               if "num_batches_tracked" not in k}}, str(path))


def _hybrid_ckpt(path):
    torch.manual_seed(0)
    tm = fp._TorchHybrid().eval()
    fp._randomize_bn(tm)
    _save(tm.state_dict(), path)
    return dict(fp.HYBRID_ARCH, PRETRAINED=str(path))


def _honet_ckpt(path):
    torch.manual_seed(4)
    bb, heads = fp._TorchResNet18().eval(), fp._TorchManoBranchHeads().eval()
    mano_trans, obj_trans = fp._TorchTransHead(out_dim=3), fp._TorchTransHead(out_dim=6)
    fp._randomize_bn(bb)
    sd = {"base_net." + k: v for k, v in bb.state_dict().items()}
    sd.update({"mano_branch." + k: v for k, v in heads.state_dict().items()})
    sd.update({"scaletrans_branch." + k: v for k, v in mano_trans.state_dict().items()})
    sd.update({"scaletrans_branch_obj." + k: v for k, v in obj_trans.state_dict().items()})
    sd["mano_layer_left.th_betas"] = torch.zeros(1, 10)  # dropped by both loaders
    _save(sd, path)
    return {"TYPE": "HoNet", "PRETRAINED": str(path), "OBJ_TRANS_FACTOR": 100.0,
            "OBJ_SCALE_FACTOR": 0.0001, "BACKBONE": {"TYPE": "ResNet18", "PRETRAINED": False},
            "HEAD": dict(MANO_HEAD), "PREVIOUS": []}


def _reg_ckpt(path):
    torch.manual_seed(0)
    bb, heads, trans = fp._TorchResNet34().eval(), fp._TorchManoBranchHeads(), fp._TorchTransHead()
    fp._randomize_bn(bb)
    sd = {"base_net." + k: v for k, v in bb.state_dict().items()}
    sd.update({"mano_branch." + k: v for k, v in heads.state_dict().items()})
    sd.update({"obj_transfhead." + k: v for k, v in trans.state_dict().items()})
    _save(sd, path)
    return {"TYPE": "HOPRegNet", "PRETRAINED": str(path),
            "BACKBONE": {"TYPE": "ResNet34", "PRETRAINED": False}, "HEAD": dict(MANO_HEAD),
            "PREVIOUS": []}


@pytest.mark.parametrize("make", [_hybrid_ckpt, _honet_ckpt, _reg_ckpt])
def test_released_checkpoint_forward_against_jax(make, tmp_path):
    cfg = make(tmp_path / "release.pth.tar")
    batch = _batch()
    jarch = j_build_arch(dict(cfg), PRESET)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    optimizer, _ = build_optimizer({"LR": 1e-4})
    state, loaded = j_load(create_train_state(jarch, optimizer, jb, jax.random.PRNGKey(0)), cfg)
    assert loaded
    jout = jarch.apply({"params": state.params, "batch_stats": state.batch_stats}, jb,
                       train=False)
    tarch = t_build_arch(dict(cfg), PRESET)
    assert t_load(tarch, cfg)
    with torch.no_grad():
        tout = tarch.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    _hold(jout, tout)


def test_imagenet_backbone_bit_exact(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sd = layouts.write_imagenet_resnet(str(tmp_path / "checkpoints" / "imagenet" /
                                           "resnet34-b627a593.pth"), "ResNet34", seed=3)
    cfg = dict(fp.HYBRID_ARCH, BACKBONE={"TYPE": "ResNet34", "PRETRAINED": True})
    torch.manual_seed(0)
    arch = t_build_arch(dict(cfg), PRESET)
    head = {k: v.clone() for k, v in arch.model_list[0].state_dict().items()
            if not k.startswith("backbone.")}
    assert t_load(arch, cfg)
    got = arch.model_list[0].state_dict()
    n = 0
    for k, v in got.items():
        if k.startswith("backbone.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k[len("backbone."):]]), k
            n += 1
        elif k in head:
            assert torch.equal(v, head[k]), k
    assert n == len(sd) - 2  # all but fc.weight and fc.bias


def test_shape_mismatch_raises(tmp_path):
    cfg = _hybrid_ckpt(tmp_path / "release.pth.tar")
    blob = torch.load(cfg["PRETRAINED"], weights_only=True)
    blob["state_dict"]["backbone.conv1.weight"] = torch.zeros(64, 3, 5, 5)
    torch.save(blob, cfg["PRETRAINED"])
    with pytest.raises(ValueError, match="shape"):
        t_load(t_build_arch(dict(cfg), PRESET), cfg)


def test_absent_files_warn_and_keep_init(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = dict(fp.HYBRID_ARCH, PRETRAINED="nowhere/release.pth.tar",
               BACKBONE={"TYPE": "ResNet34", "PRETRAINED": True})
    arch = t_build_arch(dict(cfg), PRESET)
    before = {k: v.clone() for k, v in arch.state_dict().items()}
    with caplog.at_level(logging.WARNING, logger="artiboost_torch"):
        assert not t_load(arch, cfg)
    assert all(torch.equal(v, before[k]) for k, v in arch.state_dict().items())
    messages = " ".join(r.message for r in caplog.records)
    assert "no local ImageNet weights" in messages and "not found on disk" in messages
    assert not os.path.exists(tmp_path / "checkpoints")
