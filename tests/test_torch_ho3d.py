"""The port's HO3D and HO3D v3 loaders (``artiboost_torch/datasets/ho3d.py``)
against the JAX package's, on the on-disk fixture of
``tests/test_ho3d_fixture.py``: the same files go through both classes.

Held exactly: the sample lists of every split mode (the official txt, the
v1 and v2 tables, the directory sweep), every annotation accessor, the
contact filter's choice, the evaluation split's wrist-only metas and the
cache round trip (the port's cache has its own name and never reads the
JAX package's). ``sample_batch``: every geometry key exact against both
JAX image paths. The image against the JAX default path
(``use_native=True``, ``native/hostops.cpp``): without augmentation at ROADMAP
C's bound (>= 99.9 % within 1e-5, all within 1e-4); with it all within 1e-4
and >= 90 % within 1e-5. On these noise frames every pixel is an edge, and
the native warp's FMA moves a rotated sample position by its last bit
(measured: 95.9 % and 97.8 % within 1e-5, max 3.96e-5; SyntheticHO frames
reach 99.98 %). The JAX python path (``__getitem__``,
``utils/img_augment.py``) warps with ``cv2.warpAffine``: without
augmentation all within 1e-4 (measured max 2.9e-5); with it, it blurs and
jitters the whole raw frame before the crop (the contrast mean is the
frame's, not the crop's), another image: held at mean |d| < 5e-3 and max
< 0.15 (measured 1.1e-3 and 0.074). ``decode_rgb`` reads with OpenCV, as
JAX reads: PNG frames bit-equal, and HO3D v3's JPEG frames within one
level of 255 (measured: bit-equal, one OpenCV decoding both)."""
import os
import pickle

import cv2
import numpy as np
import pytest

from artiboost_torch.datasets.ho3d import HO3D as THO3D
from artiboost_torch.datasets.ho3d import HO3DV3 as THO3DV3
from artiboost_torch.datasets.hodata import decode_rgb
from artiboost_tpu.datasets.ho3d import HO3D as JHO3D
from artiboost_tpu.datasets.ho3d import HO3DV3 as JHO3DV3
from tests.test_ho3d_fixture import PRESET, _write_seq

AUG = {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}


@pytest.fixture
def root(tmp_path, monkeypatch):
    base = os.path.join(str(tmp_path), "HO3D", "train")
    _write_seq(base, "ABF10", 3, with_mano=True)
    _write_seq(base, "SM1", 2)
    _write_seq(base, "MC1", 2)
    monkeypatch.chdir(str(tmp_path))
    return str(tmp_path)


def _pair(root, split="train", mode="paper", preset=PRESET, jcls=JHO3D, tcls=THO3D, **kw):
    cfg = dict(DATA_SPLIT=split, DATA_ROOT=root, SPLIT_MODE=mode, **kw)
    return (jcls(DATA_PRESET=preset, **cfg), tcls(DATA_PRESET=preset, device="cpu", **cfg))


ACCESSORS = ("get_cam_intr", "get_joints_3d", "get_corners_3d", "get_corners_can",
             "get_obj_transf", "get_obj_idx", "get_obj_verts_can", "get_hand_pose",
             "get_hand_shape", "get_hand_verts_3d", "get_sides", "get_joints_2d",
             "get_corners_2d")


def assert_same_dataset(jds, tds):
    """Sample lists and every accessor of every sample, exactly."""
    assert len(tds) == len(jds)
    assert [(s["img"], s["seq"]) for s in tds.samples] == \
        [(s["img"], s["seq"]) for s in jds.samples]
    for i in range(len(jds)):
        for name in ACCESSORS:
            want, got = getattr(jds, name)(i), getattr(tds, name)(i)
            if want is None or isinstance(want, (str, int)):
                assert got == want, (name, i)
            else:
                assert got.dtype == want.dtype, (name, i)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {i}")


@pytest.mark.parametrize("split,mode,txt", [
    ("train", "paper", None),   # no train.txt: the directory sweep
    ("val", "paper", None),
    ("train", "v1", None),
    ("test", "v1", None),
    ("train", "paper", "ABF10/0000\nABF10/0002\nSM1/0001\n"),
    ("train", "v2", "ABF10/0002\nABF10/0000\nMC1/0000\nSM1/0001\n"),
    ("trainval", "paper", "ABF10/0000\nABF10/0002\nSM1/0001\n"),
])
def test_sample_lists_and_annotations(root, split, mode, txt):
    if txt:
        with open(os.path.join(root, "HO3D", "train.txt"), "w") as f:
            f.write(txt)
    jds, tds = _pair(root, split, mode)
    assert_same_dataset(jds, tds)


def _write_meshes(root):
    """A small YCB mesh near the hand for the contact filter and the
    object vertices, and one far frame in a new sequence."""
    mesh_dir = os.path.join(root, "YCB_models_supp", "006_mustard_bottle")
    os.makedirs(mesh_dir, exist_ok=True)
    with open(os.path.join(mesh_dir, "textured_simple_ds.obj"), "w") as f:
        for v in [(0.02, 0.01, 0.0), (0.03, 0.0, 0.0), (0.02, 0.02, 0.01)]:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        f.write("f 1 2 3\n")
    base = os.path.join(root, "HO3D", "train")
    _write_seq(base, "ABF11", 1, rng=np.random.RandomState(7), with_mano=True)
    p = os.path.join(base, "ABF11", "meta", "0000.pkl")
    with open(p, "rb") as fh:
        meta = pickle.load(fh)
    meta["objTrans"] = np.array([5.0, 5.0, 5.0], np.float32)
    with open(p, "wb") as fh:
        pickle.dump(meta, fh)


def test_contact_filter_and_object_vertices(root):
    _write_meshes(root)
    preset = dict(PRESET, FILTER_NO_CONTACT=True, FILTER_THRESH=50.0)
    jds, tds = _pair(root, preset=preset)
    assert "ABF11" not in {s["seq"] for s in tds.samples}
    assert "ABF10" in {s["seq"] for s in tds.samples}
    assert_same_dataset(jds, tds)
    assert tds.get_obj_verts_can(0).shape == (3, 3)


def test_eval_split_wrist_only(root):
    eval_base = os.path.join(root, "HO3D", "evaluation")
    _write_seq(eval_base, "SM1", 2, rng=np.random.RandomState(5))
    for f in range(2):
        p = os.path.join(eval_base, "SM1", "meta", f"{f:04d}.pkl")
        with open(p, "rb") as fh:
            meta = pickle.load(fh)
        meta["handJoints3D"] = meta["handJoints3D"][0]
        with open(p, "wb") as fh:
            pickle.dump(meta, fh)
    jds, tds = _pair(root, "test", "paper")
    assert len(tds) == 2
    assert_same_dataset(jds, tds)
    np.testing.assert_array_equal(tds.get_hand_pose(0)[3:], np.zeros(45, np.float32))


def test_cache_round_trip(root):
    """The port writes and reads its own cache file; a JAX cache beside it
    is not read (it names the same frames with a stale list here)."""
    preset = dict(PRESET, USE_CACHE=True)
    jds, tds = _pair(root, preset=preset)
    files = sorted(os.listdir(os.path.join(root, "common", "cache")))
    assert len(files) == 2 and any(f.startswith("ho3d_torch_") for f in files), files
    jax_cache = next(f for f in files if not f.startswith("ho3d_torch_"))
    np.savez_compressed(os.path.join(root, "common", "cache", jax_cache),
                        samples=np.asarray(jds.samples[:1], dtype=object))
    again = THO3D(DATA_PRESET=preset, DATA_SPLIT="train", DATA_ROOT=root, SPLIT_MODE="paper",
                  device="cpu")
    assert_same_dataset(jds, again)
    assert_same_dataset(jds, tds)


@pytest.mark.parametrize("aug", [False, True])
def test_sample_batch_against_jax(root, aug):
    """Two batches in a row (the RandomState carries over): the JAX default
    path and the port, and separately the JAX python path and the port.
    A batch holds frames with MANO fits (ABF10, 0-2) or without (MC1, 3-4),
    not both: the JAX collate stacks the first sample's keys."""
    kw = dict(AUG=aug, AUG_PARAM=AUG if aug else None, SEED=3)
    for native in (True, False):
        jds, tds = _pair(root, **kw)
        for idx in ([0, 2, 1, 0], [3, 4, 4, 3]):
            ref = jds.sample_batch(idx, use_native=native)
            got = {k: v.numpy() for k, v in tds.sample_batch(idx).items()}
            assert set(got) == set(ref)
            for k, v in ref.items():
                if k != "image":
                    np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
            assert got["image"].shape == ref["image"].shape == (4, 64, 64, 3)
            err = np.abs(got["image"] - ref["image"])
            if native or not aug:
                assert err.max() <= 1e-4, err.max()
                assert (err <= 1e-5).mean() >= (0.9 if aug else 0.999) or not native
            else:
                assert err.mean() < 5e-3 and err.max() < 0.15, (err.mean(), err.max())


def test_png_decodes_as_cv2(root):
    """``decode_rgb`` gives ``cv2.imread``'s pixels in RGB order."""
    path = os.path.join(root, "HO3D", "train", "ABF10", "rgb", "0001.png")
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(decode_rgb(path), want)


def test_ho3dv3_jpeg(tmp_path, monkeypatch):
    """HO3D v3 reads JPEG frames: annotations exact; the decode against
    the JAX class's ``cv2.imread`` within one level of 255 (measured max 0
    levels); the batch image within ROADMAP C's bound plus that level."""
    base = os.path.join(str(tmp_path), "HO3D_v3", "train")
    _write_seq(base, "ABF10", 3, with_mano=True)
    for f in range(3):
        png = os.path.join(base, "ABF10", "rgb", f"{f:04d}.png")
        cv2.imwrite(png.replace(".png", ".jpg"), cv2.imread(png))
        os.remove(png)
    monkeypatch.chdir(str(tmp_path))
    jds, tds = _pair(str(tmp_path), jcls=JHO3DV3, tcls=THO3DV3)
    assert_same_dataset(jds, tds)
    levels = max(int(np.abs(tds.get_image(i).astype(int) - jds.get_image(i).astype(int)).max())
                 for i in range(3))
    assert levels <= 1, levels
    ref = jds.sample_batch([0, 1, 2], use_native=True)
    got = tds.sample_batch([0, 1, 2])
    err = np.abs(got["image"].numpy() - ref["image"])
    assert err.max() <= 1e-4 + levels / 255.0, err.max()
