"""MANO FK, the rotation center and the synthetic asset stand-ins of the
port (``artiboost_torch``) against the JAX package.

Tolerances: FK and rotation_center at atol 1e-5 m (float32 sums in
another order); the numpy-built assets (MANO model, object and grasp
libraries, hand colour banks, textures and UVs, render LOD) bit for bit.
The background bank is a bilinear upsample: JAX contracts its weight
matrices in XLA, the port in torch, so it is held at atol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artiboost_torch.artiboost import grasp_library as t_grasp
from artiboost_torch.artiboost import object_library as t_obj
from artiboost_torch.artiboost import renderer as t_rend
from artiboost_torch.mano import layer as t_layer
from artiboost_torch.mano import model as t_model
from artiboost_tpu.artiboost import grasp_library as j_grasp
from artiboost_tpu.artiboost import object_library as j_obj
from artiboost_tpu.artiboost import renderer as j_rend
from artiboost_tpu.mano import layer as j_layer
from artiboost_tpu.mano import model as j_model


@pytest.fixture(scope="module")
def models():
    return j_model.synthetic_mano_model(), t_model.synthetic_mano_model(device="cpu")


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy() if torch.is_tensor(b) else b,
                                  err_msg=msg)


def test_mano_model_bit_equal(models):
    jm, tm = models
    for name in j_model.ManoModel._fields:
        _eq(getattr(jm, name), getattr(tm, name), name)


@pytest.mark.parametrize("center_idx", [None, 9])
def test_mano_forward(models, center_idx):
    jm, tm = models
    rng = np.random.RandomState(1)
    pose = (rng.randn(6, 48) * 0.4).astype(np.float32)
    pose[0] = 0.0  # identity rotations take the small-angle branch
    shape = (rng.randn(6, 10) * 0.5).astype(np.float32)
    jo = j_layer.mano_forward(jm, jnp.asarray(pose), jnp.asarray(shape), center_idx=center_idx)
    to = t_layer.mano_forward(tm, torch.from_numpy(pose), torch.from_numpy(shape),
                              center_idx=center_idx)
    for name in ("verts", "joints", "transforms_abs"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    rc_j = j_layer.rotation_center(jm, jnp.asarray(shape))
    rc_t = t_layer.rotation_center(tm, torch.from_numpy(shape))
    np.testing.assert_allclose(rc_t.numpy(), np.asarray(rc_j), atol=1e-5, rtol=0)


def test_object_and_grasp_libraries_bit_equal():
    names = ["a", "b", "c", "d"]
    jl, tl = j_obj.synthetic_object_library(names), t_obj.synthetic_object_library(names, device="cpu")
    for field in ("verts", "vert_valid", "faces", "face_valid", "colors", "corners_can",
                  "n_verts", "uvs", "textures"):
        _eq(getattr(jl, field), getattr(tl, field), field)
    jg, tg = j_grasp.synthetic_grasp_library(4, 16), t_grasp.synthetic_grasp_library(4, 16, device="cpu")
    for field in ("hand_pose", "hand_shape", "hand_tsl"):
        _eq(getattr(jg, field), getattr(tg, field), field)


def test_render_assets(models):
    jm, tm = models
    ja = j_rend.default_render_assets(jm)
    ta = t_rend.default_render_assets(tm, device="cpu")
    for field in ("hand_faces", "hand_color_bank", "hand_uvs", "hand_textures"):
        _eq(getattr(ja, field), getattr(ta, field), field)
    np.testing.assert_allclose(ta.backgrounds.numpy(), np.asarray(ja.backgrounds),
                               atol=1e-6, rtol=0)
    lib_j = j_obj.synthetic_object_library(["a", "b", "c", "d"])
    lib_t = t_obj.synthetic_object_library(["a", "b", "c", "d"], device="cpu")
    lod_j = j_rend.build_scene_lod(np.asarray(jm.v_template), np.asarray(jm.faces),
                                   ja.hand_color_bank, lib_j, 128, hand_uv_bank=ja.hand_uvs)
    lod_t = t_rend.build_scene_lod(tm.v_template.numpy(), tm.faces.numpy(),
                                   ta.hand_color_bank, lib_t, 128, hand_uv_bank=ta.hand_uvs,
                                   device="cpu")
    for field in j_rend.SceneLOD._fields:
        _eq(getattr(lod_j, field), getattr(lod_t, field), field)
