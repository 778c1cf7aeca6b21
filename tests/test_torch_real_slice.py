"""The real-data slice as a whole, on the CPU: ``artiboost_torch.train.run``
on config/synthetic_smoke.yaml at 64x64 with DATASET.TRAIN an HO3D fixture
(16 frames at 640x480 written by ``datasets/layouts.py``, augmented) and
DATASET.TEST its evaluation split (20 frames): one epoch of 3 mixed steps
(5 HO3D + 11 synth of 16), the mining reweight and a TEST pass through
``padded_host_loader``, against the JAX loop (``tests/test_torch_gate.py``'s
``_jax_gate``: the loop of ``train/train_artiboost.py:342-378`` with every
draw recorded and replayed into the port, from the flax initialisation; the
JAX side reads the same files through its own HO3D class). The val sweep,
pure synthesis that the family gates hold, is closed (VAL_START_EPOCH 2),
to keep the suite's time. ``tests/test_torch_real_slice_witness.py`` runs
it at 6 steps and 128 x 128, on a second seed, with JAX's synth batches
replayed, and the port against itself at another thread count (readings
in ROADMAP C).

Held: the real half of every train batch against JAX's, geometry exactly
and the image at ROADMAP C's bound (>= 99.9 % within 1e-5, all within
1e-4; measured 99.985 %, max 1.31e-5); the first step's loss within 1e-3
relative (2.11e-4); every step's loss within the Clas gate's 6e-2
(3.14e-3); the train and TEST passes' measures within its bounds
(``_bound``: Mean3DEPE 2.2e-2, measured 5.2e-4; val_epe_mean 1.2e-2,
1.4e-4; LossesMetric 2.5e-2, 9.1e-4, its ordinal terms 0.18, 2.8e-3). The
released recipe through the entry point on an HO3D fixture is
``tests/test_torch_real_entry.py``.

JAX's entry point also takes one mixed batch from the loader before epoch
0 to initialise the flax state (``train_artiboost.py:296``), which moves
the real dataset's RandomState one batch on; the port needs no such batch,
so its real halves are those of the JAX loop as the gates run it
(ROADMAP C)."""
import os
import sys

import numpy as np
import pytest
import yaml

from tests.test_torch_gate import _bound, run_jax_gate, run_torch_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJS = ("010_potted_meat_can", "021_bleach_cleanser")
AUG = {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}


def write_fixture(d, frames=8, seed=21):
    """HO3D train (2 x ``frames`` frames, MANO fits) and evaluation (20)
    splits under ``d``/data; -> the data root."""
    from artiboost_torch.datasets import layouts

    rng = np.random.RandomState(seed)
    data = os.path.join(str(d), "data")
    layouts.write_ho3d(data, "train", {"ABF10": frames, "SB12": frames}, OBJS, rng, n_images=4)
    layouts.write_ho3d(data, "test", {"SM1": 20}, OBJS, rng, n_images=2)
    return data


def slice_config(d, size=64, frames=8, config_len=32, seed=21):
    """config/synthetic_smoke.yaml with its DATASET on the HO3D fixture
    (``write_fixture``), at ``size`` x ``size`` with CONFIG_LEN_TRAIN
    ``config_len``: (2 x ``frames`` + ``config_len``) / 16 steps. ``seed``
    makes the fixture's files and the train split's augmentation draws."""
    from artiboost_torch.utils.config import load_config

    data = write_fixture(d, frames, seed)
    cfg = load_config(os.path.join(REPO, "config", "synthetic_smoke.yaml"))
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[size, size], HEATMAP_SIZE=[size // 8, size // 8])
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=config_len, VAL_START_EPOCH=2)  # no val sweep
    cfg["DATASET"] = {
        "TRAIN": {"TYPE": "HO3D", "DATA_SPLIT": "train", "DATA_ROOT": data, "SEED": seed - 20,
                  "SPLIT_MODE": "paper", "AUG": True, "AUG_PARAM": AUG},
        "TEST": {"TYPE": "HO3D", "DATA_SPLIT": "test", "DATA_ROOT": data,
                 "SPLIT_MODE": "paper", "AUG": False, "AUG_PARAM": None}}
    path = os.path.join(str(d), "real_smoke.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jax_real_gate(path_out, cache_dir, cfg_path, synth_batches=False):
    """Subprocess body: ``_jax_gate`` on the config, the datasets built by
    the JAX package's registry, every real train batch recorded (with
    ``synth_batches`` every synth batch too)."""
    import tests.test_torch_gate as gate
    from artiboost_tpu.utils.registry import DATASET, build_from_cfg

    real = []

    def split_dataset(base, cfg, split):
        ds = build_from_cfg(dict(cfg["DATASET"][split]), DATASET,
                            {"DATA_PRESET": cfg["DATA_PRESET"]})
        if split == "TRAIN":
            orig = ds.sample_batch

            def sample_batch(idx, use_native=None):
                batch = orig(idx, use_native)
                real.append({k: np.asarray(v).copy() for k, v in batch.items()})
                return batch

            ds.sample_batch = sample_batch
        return ds

    gate.split_dataset = split_dataset
    gate._jax_gate(path_out, cache_dir, cfg_path=cfg_path, epochs=1, val=False,
                   synth_batches=synth_batches)
    with np.load(path_out) as z:
        out = {k: z[k] for k in z.files}
    out.update({f"real/{i}/{k}": v for i, b in enumerate(real) for k, v in b.items()})
    np.savez(path_out, **out)


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    cfg_path = slice_config(tmp_path_factory.mktemp("real_fixture"))
    jax_gate = run_jax_gate(tmp_path_factory, __file__, cfg_path)
    from artiboost_torch.datasets.hodata import HODataset

    real, orig = [], HODataset.device_half

    def device_half(self, host, **kw):
        batch = orig(self, host, **kw)
        if self.data_split == "train":
            real.append({k: v.clone() for k, v in batch.items()})
        return batch

    HODataset.device_half = device_half
    try:
        ref, out, _, replay = run_torch_gate(jax_gate, cfg_path=cfg_path, epochs=1)
    finally:
        HODataset.device_half = orig
    return ref, out, replay, real


@pytest.mark.limit(490)
def test_real_slice_against_jax(gates):
    ref, out, replay, real = gates
    assert replay.count == {"triplets": 2, "poses": 2, "synth": 3, "perm": 2, "loss": 3 + 2}
    assert out["loader"]._mixed_counts() == (5, 11)
    hist = out["history"][0]
    assert hist["train"]["steps"] == 3 and "val" not in hist
    assert hist["test"]["batches"] == 2 and hist["test"]["images"] == 20
    assert len(real) == 3 == len({k.split("/")[1] for k in ref if k.startswith("real/")})
    for i, batch in enumerate(real):
        want = {k.split("/", 2)[2]: v for k, v in ref.items() if k.startswith(f"real/{i}/")}
        assert set(batch) == set(want)
        for k, v in want.items():
            got = batch[k].numpy()
            if k == "image":
                err = np.abs(got - v)
                assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-4, (i, err.max())
            else:
                np.testing.assert_array_equal(got, v, err_msg=f"{i} {k}")
    loss = np.asarray(hist["train"]["final_loss"])
    want_loss = ref["0/train_final_loss"]
    assert abs(loss[0] / want_loss[0] - 1) <= 1e-3, (loss[0], want_loss[0])
    assert np.abs(loss / want_loss - 1).max() <= 6e-2, loss / want_loss - 1
    for split in ("train", "test"):
        for name, scalars in hist[split]["measures"].items():
            for k, v in scalars.items():
                r = float(ref[f"0/{split}/{name}/{k}"])
                assert abs(v - r) <= _bound(name, k) * abs(r), (split, name, k, v, r)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_real_gate(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:] == ["replay"])
