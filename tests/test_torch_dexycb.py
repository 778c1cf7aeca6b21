"""The port's DexYCB loader (``artiboost_torch/datasets/dexycb.py``) against
the JAX package's on the on-disk fixture of ``tests/test_dexycb_fixture.py``
(plus the object's ``textured_simple.obj``, so the corners, vertices and
contact filter read a model): sample lists over the s0-s3 split matrix,
every annotation accessor, the visibility and contact filters and the cache
round trip exactly; ``sample_batch`` geometry exactly and its image at the
JPEG frames' bound (ROADMAP C: all within 1e-4 plus the decode's level
difference, measured 0 levels here)."""
import os

import numpy as np
import pytest

from artiboost_torch.datasets.dexycb import DexYCB as TDex
from artiboost_tpu.datasets.dexycb import DexYCB as JDex
from tests.test_dexycb_fixture import PRESET, _write_scene

AUG = {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}
ACCESSORS = ("get_cam_intr", "get_joints_3d", "get_corners_3d", "get_corners_can",
             "get_obj_transf", "get_obj_idx", "get_obj_verts_can", "get_hand_pose",
             "get_hand_shape", "get_hand_verts_3d", "get_sides")


def _write_model(root, rng):
    d = os.path.join(root, "models", "006_mustard_bottle")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "textured_simple.obj"), "w") as f:
        for v in rng.randn(30, 3) * 0.04:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for k in range(28):
            f.write(f"f {k + 1} {k + 2} {k + 3}\n")


@pytest.fixture
def data(tmp_path, monkeypatch):
    root = os.path.join(str(tmp_path), "data", "DexYCB")
    rng = np.random.RandomState(3)
    for si, subj in enumerate(["20200709-subject-01", "20200813-subject-02"]):
        for seq in range(6):
            _write_scene(root, subj, f"2020{si}_{seq:06d}", rng=rng, with_mano=(seq % 2 == 0))
    _write_model(root, rng)
    monkeypatch.chdir(str(tmp_path))
    return os.path.join(str(tmp_path), "data")


def _pair(data, split, mode, preset=PRESET, **kw):
    cfg = dict(DATA_SPLIT=split, DATA_ROOT=data, SPLIT_MODE=mode, **kw)
    return JDex(DATA_PRESET=preset, **cfg), TDex(DATA_PRESET=preset, device="cpu", **cfg)


def assert_same_dataset(jds, tds):
    assert len(tds) == len(jds)
    assert [s["labels"] for s in tds.samples] == [s["labels"] for s in jds.samples]
    for i in range(len(jds)):
        for name in ACCESSORS:
            want, got = getattr(jds, name)(i), getattr(tds, name)(i)
            if want is None or isinstance(want, (str, int)):
                assert got == want, (name, i)
            else:
                assert got.dtype == want.dtype, (name, i)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {i}")


@pytest.mark.parametrize("mode", ["s0", "s1", "s2", "s3"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_split_matrix(data, split, mode):
    jds, tds = _pair(data, split, mode)
    assert_same_dataset(jds, tds)


def test_filters_and_cache(data):
    """An invisible hand and the contact filter drop the same frames; the
    cached list reads back equal under the port's own file name."""
    lab = os.path.join(data, "DexYCB", "20200709-subject-01", "20200_000000", "836212060125",
                       "labels_000000.npz")
    blob = dict(np.load(lab))
    blob["joint_3d"] = np.full((21, 3), -1, np.float32)
    np.savez(lab, **blob)
    preset = dict(PRESET, FILTER_NO_CONTACT=True, FILTER_THRESH=15.0, USE_CACHE=True)
    jds, tds = _pair(data, "train", "s0", preset)
    n_all = len(_pair(data, "train", "s0")[1])
    assert 0 < len(tds) < n_all == 19
    assert_same_dataset(jds, tds)
    assert any(f.startswith("dexycb_torch_") for f in os.listdir(os.path.join("common", "cache")))
    again = TDex(DATA_PRESET=preset, DATA_SPLIT="train", DATA_ROOT=data, SPLIT_MODE="s0",
                 device="cpu")
    assert_same_dataset(jds, again)


@pytest.mark.parametrize("aug", [False, True])
def test_sample_batch_against_jax(data, aug):
    """Frames with MANO fits (even scenes) only, as the JAX collate needs."""
    jds, tds = _pair(data, "train", "s0", AUG=aug, AUG_PARAM=AUG if aug else None, SEED=5)
    idx = [i for i in range(len(tds)) if tds.get_hand_pose(i) is not None]
    for batch in (idx[:4], idx[4:8]):
        ref = jds.sample_batch(batch, use_native=True)
        got = {k: v.numpy() for k, v in tds.sample_batch(batch).items()}
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k != "image":
                np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        levels = max(int(np.abs(tds.get_image(i).astype(int) - jds.get_image(i).astype(int)
                                ).max()) for i in batch)
        err = np.abs(got["image"] - ref["image"])
        assert levels <= 1 and err.max() <= 1e-4 + levels / 255.0, (levels, err.max())
