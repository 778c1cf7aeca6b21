"""The port's host data pipeline (``artiboost_torch/utils/prefetch.py``),
mirroring tests/test_prefetch.py: order, the transform on the producer, an
abandoned iteration stopping its thread, the producer's error raised in the
consumer; and over a real dataset (an HO3D fixture written by
``datasets/layouts.py``, with augmentation, so every batch draws from the
dataset's RandomState): ``HostPipeline`` with a decode pool of 4 keeps plan
order, makes the same batches bit for bit as ``sample_batch`` on one
thread, makes no CUDA call off the main thread, surfaces a decode failure,
and stops its producer when the consumer closes mid-epoch."""
import os
import threading

import numpy as np
import pytest
import torch

from artiboost_torch.datasets import layouts
from artiboost_torch.datasets.ho3d import HO3D
from artiboost_torch.utils.prefetch import HostPipeline, Prefetcher

PRESET = {"USE_CACHE": False, "BBOX_EXPAND_RATIO": 1.2, "IMAGE_SIZE": [32, 32],
          "CENTER_IDX": 0, "CROP_MODEL": "root_obj"}
OBJS = ("010_potted_meat_can", "006_mustard_bottle")


def test_order_and_transform():
    assert list(Prefetcher(range(100), depth=4)) == list(range(100))
    assert list(Prefetcher(range(5), transform=lambda x: x * 2)) == [0, 2, 4, 6, 8]


def test_abandoned_iteration_stops_producer():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = Prefetcher(endless(), depth=1)
    it = iter(pf)
    assert next(it) == 0
    it.close()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()


def test_error_propagates():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = iter(Prefetcher(bad()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


@pytest.fixture
def data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    layouts.write_ho3d(str(tmp_path), "train", {"ABF10": 9, "SM2": 9}, OBJS,
                       np.random.RandomState(0), n_images=3)
    return str(tmp_path)


def _dataset(root):
    return HO3D(DATA_PRESET=PRESET, DATA_SPLIT="train", DATA_ROOT=root, SPLIT_MODE="paper",
                AUG=True, AUG_PARAM={"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2},
                SEED=4, device="cpu")


PLAN = [([(3 * b + k) % 18 for k in range(5)], b) for b in range(9)]


def test_pipeline_equals_unprefetched(data):
    """Nine batches of five through a pool of 4 and a ring of 4 buffers
    (reused twice): the batches and their order equal ``sample_batch``'s on
    one thread; no thread but the main one calls into torch.cuda."""
    one = _dataset(data)
    ref = [one.sample_batch(idx) for idx, _ in PLAN]
    ds, host = _dataset(data), HostPipeline(workers=4)
    cuda_calls = []
    main = threading.main_thread()

    def watch(frame, event, arg):
        if threading.current_thread() is main:
            return
        name = getattr(arg, "__name__", "") if event == "c_call" else frame.f_code.co_name
        where = frame.f_code.co_filename
        if "cuda" in name.lower() or os.sep + "cuda" + os.sep in where:
            cuda_calls.append((threading.current_thread().name, where, name))

    threading.setprofile(watch)
    try:
        got = []
        for hb, extra in host.host_halves(ds, iter(PLAN), 5):
            assert isinstance(hb.images, np.ndarray) and hb.images.dtype == np.uint8
            got.append((extra, ds.device_half(hb)))
    finally:
        threading.setprofile(None)
        host.close()
    assert [e for e, _ in got] == list(range(9))
    assert not cuda_calls, cuda_calls[:5]
    for (_, g), r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert torch.equal(g[k], r[k]), k


def test_pipeline_surfaces_decode_errors_and_stops(data):
    ds, host = _dataset(data), HostPipeline(workers=4)
    bad = ds.samples[7]["img"]
    with open(bad, "wb") as f:
        f.write(b"not an image")
    try:
        it = host.host_halves(ds, iter(PLAN), 5)
        next(it)
        with pytest.raises(Exception, match="cannot identify image file"):
            for _ in it:
                pass
        # closing mid-epoch: the producer thread ends
        before = {t.ident for t in threading.enumerate()}
        it = host.host_halves(_dataset(data), iter(PLAN[:1] * 20), 5)
        next(it)
        it.close()
        extra = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()
                 and not t.name.startswith("decode")]
        assert not extra, extra
    finally:
        host.close()
