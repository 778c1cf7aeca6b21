"""The port's FPHB loader (``artiboost_torch/datasets/fhb.py``) against the
JAX package's on the on-disk fixture of ``tests/test_fhb_fixture.py``:
subject and action splits and every annotation accessor exactly;
``sample_batch`` geometry exactly. The frames are shrunk (or, in the
fixture, grown) to ``raw_size`` by ``resize_linear``, the port's copy of
``cv2.resize``'s INTER_LINEAR: bit-equal to OpenCV at the halving of the
release's 1920x1080 frames, within one level of 255 on under 1 % of the
values at other sizes (measured 0.09 % at 480x270 -> 960x540); the batch
image within 1e-4 plus that level (ROADMAP C)."""
import os

import cv2
import numpy as np
import pytest

from artiboost_torch.datasets.fhb import FPHB as TFPHB
from artiboost_torch.datasets.fhb import resize_linear
from artiboost_tpu.datasets.fhb import FPHB as JFPHB
from tests.test_fhb_fixture import PRESET, _write_seq

ACCESSORS = ("get_cam_intr", "get_joints_3d", "get_corners_3d", "get_corners_can",
             "get_obj_transf", "get_obj_idx")


@pytest.fixture
def data(tmp_path):
    root = os.path.join(str(tmp_path), "data", "fhbhands")
    _write_seq(root, "Subject_1", "open_milk", n=3)
    _write_seq(root, "Subject_2", "pour_juice_bottle", n=2)
    _write_seq(root, "Subject_3", "put_salt", n=2, rng=np.random.RandomState(4))
    with open(os.path.join(root, "data_split_action_recognition.txt"), "w") as f:
        f.write("Training 2\nSubject_1/open_milk/1 0\nSubject_3/put_salt/1 3\n"
                "Test 1\nSubject_2/pour_juice_bottle/1 5\n")
    return os.path.join(str(tmp_path), "data")


def _pair(data, split, mode="subjects", **kw):
    cfg = dict(DATA_SPLIT=split, DATA_ROOT=data, SPLIT_MODE=mode, **kw)
    return JFPHB(DATA_PRESET=PRESET, **cfg), TFPHB(DATA_PRESET=PRESET, device="cpu", **cfg)


@pytest.mark.parametrize("mode", ["subjects", "actions"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_splits_and_annotations(data, split, mode):
    jds, tds = _pair(data, split, mode)
    assert len(tds) == len(jds) > 0
    assert [s["img"] for s in tds.samples] == [s["img"] for s in jds.samples]
    for i in range(len(jds)):
        for name in ACCESSORS:
            want, got = getattr(jds, name)(i), getattr(tds, name)(i)
            if isinstance(want, int):
                assert got == want
            else:
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {i}")


@pytest.mark.parametrize("shape,size", [((1080, 1920), (960, 540)), ((270, 480), (960, 540)),
                                        ((100, 130), (91, 57))])
def test_resize_against_cv2(shape, size):
    img = (np.random.RandomState(1).rand(*shape, 3) * 255).astype(np.uint8)
    d = np.abs(resize_linear(img, size).astype(int) - cv2.resize(img, size).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    if shape == (1080, 1920):
        assert d.max() == 0


@pytest.mark.parametrize("aug", [False, True])
def test_sample_batch_against_jax(data, aug):
    aug_param = {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2} if aug else None
    jds, tds = _pair(data, "train", AUG=aug, AUG_PARAM=aug_param, SEED=2)
    for batch in ([0, 2, 1], [4, 3, 0]):
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
