"""The port's loaders of the assets on disk against the JAX package's, on
files the port's layout writers (``artiboost_torch/datasets/layouts.py``)
and ``tests/test_assets.py`` write: the OBJ reader with its MTL texture and
baking, vertex colours winning over the texture, the packed YCB library
(HO3D flip, bbox centring, the stride decimation above 2,048 vertices, the
texture atlas), ``get_object_library``'s search order and fallback, the
grasp pickles with repeat padding, the background pool and the HTML hands.
Integers exactly, floats within 1e-6."""
import os
import pickle

import numpy as np
import pytest
import torch

from artiboost_torch.datasets import layouts

OBJS = ["010_potted_meat_can", "021_bleach_cleanser"]


def _close(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=what)


def test_obj_texture_bake_and_vertex_colors(tmp_path):
    """The fixtures of tests/test_assets.py through both readers."""
    from PIL import Image

    from artiboost_torch.artiboost.object_library import load_obj_file as t_load
    from artiboost_tpu.artiboost.object_library import load_obj_file as j_load

    d = tmp_path / "obj"
    os.makedirs(d)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4], tex[:, 4:] = (255, 0, 0), (0, 0, 255)
    Image.fromarray(tex).save(d / "texture_map.png")
    (d / "model.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.1 0.5\nvt 0.9 0.5\n"
                                 "vt 0.1 0.5\nf 1/1 2/2 3/3\n")
    (d / "colored.obj").write_text("v 0 0 0 0.5 0.25 0.125\nv 1 0 0 0.5 0.25 0.125\n"
                                   "v 0 1 0 0.5 0.25 0.125\nvt 0 0\nf 1/1 2/1 3/1\n")
    for name in ("model.obj", "colored.obj"):
        got, want = t_load(str(d / name), with_uv=True), j_load(str(d / name), with_uv=True)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None), (name, i)
            if w is not None:
                _close(g, w, f"{name} {i}")
    assert np.allclose(t_load(str(d / "model.obj"))[2][1], [0, 0, 1], atol=0.02)
    np.testing.assert_array_equal(t_load(str(d / "colored.obj"))[2], [[0.5, 0.25, 0.125]] * 3)


@pytest.mark.parametrize("dataset_type", ["HO3D", "DexYCB"])
def test_packed_library_with_decimation(tmp_path, dataset_type):
    """Meshes of 40 x 64 = 2,560 vertices (decimated to 2,048) and 12 x 16
    (kept), each with an MTL and a 300 x 300 texture (resized to the
    atlas's 256)."""
    from artiboost_torch.artiboost.object_library import load_object_library as t_lib
    from artiboost_tpu.artiboost.object_library import load_object_library as j_lib

    root = str(tmp_path / "models")
    rng = np.random.RandomState(0)
    layouts.write_ycb_models(root, OBJS[:1], rng, n_lat=40, n_lon=64, tex_size=300)
    layouts.write_ycb_models(root, OBJS[1:], rng, n_lat=12, n_lon=16, tex_size=300)
    got = t_lib(OBJS, root, dataset_type, device="cpu")
    want = j_lib(OBJS, root, dataset_type)
    assert got.names == want.names
    assert got.verts.shape == (2, 2048, 3) and int(got.n_verts[0]) == 2048
    assert int(got.n_verts[1]) == 12 * 16
    for field in ("verts", "vert_valid", "faces", "face_valid", "colors", "corners_can",
                  "n_verts", "uvs", "textures"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        if field in ("faces", "n_verts"):
            w = w.astype(np.int64)
        _close(g, w, field)


def test_get_object_library_search_and_fallback(tmp_path, monkeypatch, caplog):
    """``./data/YCB_models_process`` first, then ``./data/DexYCB/models``;
    neither: the synthetic library with the JAX package's warning."""
    from artiboost_torch.artiboost.object_library import get_object_library

    monkeypatch.chdir(tmp_path)
    lib = get_object_library(OBJS, device="cpu")
    assert any("YCB object assets not found" in r.message for r in caplog.records)
    assert lib.verts.shape == (2, 512, 3)
    rng = np.random.RandomState(1)
    layouts.write_ycb_models("data/DexYCB/models", OBJS, rng, n_lat=6, n_lon=8, tex_size=16)
    assert get_object_library(OBJS, "DexYCB", device="cpu").verts.shape == (2, 48, 3)
    layouts.write_ycb_models("data/YCB_models_process", OBJS, rng, n_lat=5, n_lon=8, tex_size=16)
    assert get_object_library(OBJS, device="cpu").verts.shape == (2, 40, 3)


def test_grasp_library(tmp_path, monkeypatch):
    """50 grasps per object, one object with 7 (repeat-padded), one grasp
    with scalar shape and tsl (kept zero)."""
    from artiboost_torch.artiboost.grasp_library import get_grasp_library
    from artiboost_tpu.artiboost.grasp_library import get_grasp_library as j_get

    gdir = str(tmp_path / "ycb_grasp")
    layouts.write_grasps(gdir, OBJS, 50, np.random.RandomState(2))
    with open(os.path.join(gdir, OBJS[1] + ".pkl"), "rb") as f:
        grasps = pickle.load(f)[:7]
    grasps[3] = (grasps[3][0], 0, 0)
    with open(os.path.join(gdir, OBJS[1] + ".pkl"), "wb") as f:
        pickle.dump(grasps, f)
    got, want = get_grasp_library(OBJS, 50, gdir, device="cpu"), j_get(OBJS, 50, gdir)
    for g, w in zip(got, want):
        _close(g, w, "grasps")
    np.testing.assert_array_equal(got.hand_pose[1, 7].numpy(), got.hand_pose[1, 0].numpy())
    monkeypatch.chdir(tmp_path)
    assert get_grasp_library(OBJS, 50, device="cpu").hand_pose.shape == (2, 50, 48)


def test_backgrounds_and_html_hands(tmp_path):
    from artiboost_torch.artiboost import renderer as t_r
    from artiboost_torch.mano.model import get_mano_model
    from artiboost_tpu.artiboost import renderer as j_r

    rng = np.random.RandomState(3)
    layouts.write_backgrounds(str(tmp_path / "bgs" / "sub"), 5, rng, size=(40, 30))
    _close(t_r.load_backgrounds(str(tmp_path / "bgs"), size=32),
           j_r.load_backgrounds(str(tmp_path / "bgs"), size=32), "backgrounds")
    assert t_r.load_backgrounds(str(tmp_path / "none")) is None
    mano = get_mano_model(device="cpu")
    layouts.write_html_hands(str(tmp_path / "html"), range(4), mano.v_template.numpy(),
                             mano.faces.numpy(), rng, tex_size=64)
    got, want = (t_r.load_html_hand_assets(str(tmp_path / "html")),
                 j_r.load_html_hand_assets(str(tmp_path / "html")))
    assert got[0].shape == (3, 778, 3)  # html_002 is skipped, as in the reference
    for g, w in zip(got, want):
        _close(g, w, "html")
    _close(t_r.load_html_hand_colors(str(tmp_path / "html")), want[0], "html colors")
    assert t_r.load_html_hand_assets(str(tmp_path / "none")) is None
    assets = t_r.default_render_assets(mano, bgs_path=str(tmp_path / "bgs"),
                                       html_path=str(tmp_path / "html"), device="cpu")
    assert assets.backgrounds.shape == (5, 336, 336, 3) and assets.hand_textures.shape[0] == 3
