"""The port's data path against the JAX package on the CPU: the real-data
batch assembly (``artiboost_torch/datasets/hodata.py``), the SyntheticHO
images rendered by the Gouraud raster (``datasets/synthetic.py``) and the
masked key union of mixed batches (``utils/batching.py``).

Tolerances, each stated where it is held:
  * ``sample_batch`` against the JAX package's default path
    (``sample_batch(use_native=True)``, ``native/hostops.cpp``): every
    geometry key exact (both draw the same numpy numbers and run the same
    numpy code); the image >= 99.9 % within 1e-5 and all within 1e-4. The
    native library is built with -march=native, and its warp, blur and
    jitter hold 126 FMA instructions where the port rounds a*b+c twice: a
    last-bit move of a sample coordinate at a silhouette edge moves the
    value by up to its step times 2^-16. Measured on SyntheticHO images:
    8 of 49,152 values beyond 1e-5, the largest 2.6e-5;
  * SyntheticHO images from the JAX run's draws: >= 99.9 % of the uint8
    values equal, >= 99.99 % of the pixels within 2 levels (of 255) and all
    within 32. FK and the Lambert shade sum in another order than XLA
    (ROADMAP C): the 8-bit quantisation turns a last-bit difference into
    one level, and on a few pixels a vertex moved in its last bit hands the
    pixel to the neighbouring face, whose Gouraud colour differs by more.
    Measured: see the test's docstring;
  * ``union_concat`` key sets, masks and values exact."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._proc import NO_FMA, subprocess_env

SYNTH = {"TYPE": "SyntheticHO", "DATA_SPLIT": "train", "AUG": True, "N_SAMPLES": 16,
         "RAW_SIZE": 128, "AUG_PARAM": {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}}
PRESET = {"BBOX_EXPAND_RATIO": 1.2, "IMAGE_SIZE": [64, 64], "CENTER_IDX": 0,
          "CROP_MODEL": "root_obj", "FULL_IMAGE": False}


def _fixture(n=6, raw=256):
    """Images and annotations of a port SyntheticHO (its own seeded draws):
    flat-shaded hand and object over smooth backgrounds, 256 x 256."""
    from artiboost_torch.datasets.synthetic import SyntheticHO

    ds = SyntheticHO(DATA_PRESET=PRESET, device="cpu", **dict(SYNTH, N_SAMPLES=n, RAW_SIZE=raw))
    return {"images": ds.images.numpy(), "intr": ds._intr, "raw": raw, "joints": ds._joints,
            "corners_can": ds._corners_can, "obj_pose": ds._obj_pose,
            "obj_verts_can": ds._obj_verts_can, "hand_verts": ds._hand_verts,
            "hand_pose": ds._hand_pose, "hand_shape": ds._hand_shape, "obj_id": ds._obj_id}


def _accessors(cls, fx, side):
    """A dataset class over the fixture, on either package's HODataset."""

    class Fixture(cls):
        def __init__(self, **cfg):
            super().__init__(**cfg)
            self.raw_size = (fx["raw"], fx["raw"])

        def __len__(self):
            return len(fx["images"])

        def get_image(self, idx):
            return fx["images"][idx]

        def get_images(self, idx):
            return torch.from_numpy(fx["images"])[idx]

        def get_sides(self, idx):
            return side

        def get_cam_intr(self, idx):
            return fx["intr"]

        def get_joints_3d(self, idx):
            return fx["joints"][idx]

        def get_corners_3d(self, idx):
            T = fx["obj_pose"][idx]
            return fx["corners_can"][idx] @ T[:3, :3].T + T[:3, 3]

        def get_corners_can(self, idx):
            return fx["corners_can"][idx]

        def get_obj_verts_can(self, idx):
            return fx["obj_verts_can"][idx]

        def get_obj_transf(self, idx):
            return fx["obj_pose"][idx]

        def get_obj_idx(self, idx):
            return int(fx["obj_id"][idx]) + 1

        def get_hand_verts_3d(self, idx):
            return fx["hand_verts"][idx]

        def get_hand_pose(self, idx):
            return fx["hand_pose"][idx]

        def get_hand_shape(self, idx):
            return fx["hand_shape"][idx]

    return Fixture


@pytest.mark.parametrize("side", ["right", "left"])
def test_sample_batch_against_jax_native(side):
    """Two batches in a row (the dataset's RandomState carries over), with
    augmentation; "left" exercises the side flip of image and geometry."""
    from artiboost_torch.datasets.hodata import HODataset as THOD
    from artiboost_tpu import native
    from artiboost_tpu.datasets.hodata import HODataset as JHOD

    assert native.available()
    fx = _fixture()
    cfg = dict(DATA_SPLIT="train", AUG=True, SEED=3,
               AUG_PARAM={"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2})
    jds = _accessors(JHOD, fx, side)(DATA_PRESET=PRESET, **cfg)
    tds = _accessors(THOD, fx, side)(DATA_PRESET=PRESET, device="cpu", **cfg)
    for idx in ([0, 3, 5, 1], [2, 2, 4, 0]):
        ref = jds.sample_batch(idx, use_native=True)
        got = tds.sample_batch(idx)
        assert set(got) == set(ref)
        for k, v in ref.items():
            g = got[k].numpy()
            if k == "image":
                assert g.dtype == np.float32 and g.shape == v.shape
                err = np.abs(g - v)
                assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-4, err.max()
            else:
                np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def test_padded_host_loader_against_jax():
    """The eval iteration over a whole dataset of 5 samples in batches of 4,
    without augmentation: the same batches as the JAX package's
    ``padded_host_loader``, the last one repeat-padded and carrying
    SAMPLE_VALID; keys exact but the image, which is held as in
    test_sample_batch_against_jax_native."""
    from artiboost_torch.datasets.hodata import HODataset as THOD
    from artiboost_torch.datasets.hodata import padded_host_loader as t_loader
    from artiboost_tpu.datasets.hodata import HODataset as JHOD
    from artiboost_tpu.datasets.hodata import padded_host_loader as j_loader

    fx = _fixture(n=5, raw=128)
    cfg = dict(DATA_SPLIT="test", AUG=False)
    jds = _accessors(JHOD, fx, "right")(DATA_PRESET=PRESET, **cfg)
    tds = _accessors(THOD, fx, "right")(DATA_PRESET=PRESET, device="cpu", **cfg)
    ref, got = list(j_loader(jds, 4)), list(t_loader(tds, 4))
    assert len(got) == len(ref) == 2
    assert "sample_valid" not in got[0]
    np.testing.assert_array_equal(got[1]["sample_valid"].numpy(), [1, 0, 0, 0])
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, v in r.items():
            if k == "image":
                err = np.abs(g[k].numpy() - v)
                assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-4, err.max()
            else:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(v), err_msg=k)


def _jax_synthetic(path_out):
    """Subprocess body: JAX SyntheticHO with its draws recorded."""
    import jax

    from artiboost_tpu.datasets.synthetic import SyntheticHO

    _, out = synthetic_ho_reference(SyntheticHO, jax, SYNTH, PRESET)
    np.savez(path_out, **out)


def synthetic_ho_reference(cls, jax, cfg, preset):
    """JAX SyntheticHO init -> (the dataset, its draws (synthetic.py:56-81)
    flattened: ids, poses/view/*, poses/scram/tsl, tex, render/<chunk>/*;
    and the images and annotations under ref/*). Also used by
    tests/test_torch_train.py."""
    n, size, seed = int(cfg["N_SAMPLES"]), int(cfg["RAW_SIZE"]), int(cfg.get("SEED", 0))
    ds = cls(**dict(cfg, DATA_PRESET=preset))
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    k_view, k_scram = jax.random.split(jax.random.fold_in(key, 9))
    kv1, kv2, kv3 = jax.random.split(k_view, 3)
    ku, kt = jax.random.split(kv1)
    out = {"oid": jax.random.randint(k1, (n,), 0, 4), "vid": jax.random.randint(k2, (n,), 0, 48),
           "gid": jax.random.randint(k3, (n,), 0, 16),
           "poses/view/u": jax.random.uniform(ku, (n,)),
           "poses/view/theta": jax.random.uniform(kt, (n,)),
           "poses/view/roll": jax.random.uniform(kv2, (n,)),
           "poses/view/z": jax.random.uniform(kv3, (n,), minval=0.45, maxval=0.55),
           "poses/scram/tsl": jax.random.normal(k_scram, (n, 3)),
           "tex": jax.random.randint(jax.random.fold_in(key, 7), (n,), 0, 8)}
    n_grid = len(np.unique(np.linspace(0, size // 2, 4).round())) ** 2
    for i, s in enumerate(range(0, n, 16)):
        b = min(16, n - s)
        k_light, k_bg, k_pos, _ = jax.random.split(jax.random.fold_in(key, s), 4)
        out[f"render/{i}/light"] = jax.random.uniform(k_light, (b, 1), minval=1.0, maxval=5.0)
        out[f"render/{i}/bg_pos"] = jax.random.randint(k_pos, (b,), 0, n_grid)
        out[f"render/{i}/bg_id"] = jax.random.randint(k_bg, (b,), 0, 8)
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update({"ref/images": ds._images, "ref/joints": ds._joints,
                "ref/hand_pose": ds._hand_pose, "ref/obj_pose": ds._obj_pose})
    return ds, out


def synthetic_ho_draws(ref, prefix=""):
    """The recorded JAX draws (keys under ``prefix``) in the port's
    ``synthetic_ho_draws`` layout."""
    def t(k):
        v = ref[prefix + k]
        return torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)

    n_chunks = len({k[len(prefix):].split("/")[1] for k in ref
                    if k.startswith(prefix + "render/")})
    return {"oid": t("oid"), "vid": t("vid"), "gid": t("gid"), "tex": t("tex"),
            "poses": {"view": {k: t(f"poses/view/{k}") for k in ("u", "theta", "roll", "z")},
                      "scram": {"tsl": t("poses/scram/tsl")}},
            "render": [{k: t(f"render/{i}/{k}") for k in ("light", "bg_pos", "bg_id")}
                       for i in range(n_chunks)]}


def run_jax_subprocess(script, *args, timeout=240):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = subprocess_env(*NO_FMA)
    res = subprocess.run([sys.executable, script, *map(str, args)], env=env,
                         capture_output=True, text=True, timeout=timeout, cwd=repo)
    assert res.returncode == 0, res.stderr[-4000:]


@pytest.fixture(scope="module")
def jax_synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_ref")
    run_jax_subprocess(__file__, d / "ref.npz")
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def test_synthetic_ho_against_jax(jax_synth):
    """16 scenes at 128 x 128 from the JAX run's draws. Measured: 99.981 %
    of the uint8 values equal (149 of 786,432 differ); 9 of 262,144 pixels
    more than 2 levels apart, the largest 14 (a winner flip between two
    adjacent hand faces); joints within 1.2e-7 m, the object pose within
    1.6e-6 and the MANO pose within 4.8e-7."""
    from artiboost_torch.datasets.synthetic import SyntheticHO
    from artiboost_torch.ops.rasterizer_cuda import raster_rgb

    ref = jax_synth
    ds = SyntheticHO(DATA_PRESET=PRESET, device="cpu", draws=synthetic_ho_draws(ref), **SYNTH)
    img, jimg = ds.images.numpy(), ref["ref/images"]
    assert img.dtype == np.uint8 and img.shape == jimg.shape == (16, 128, 128, 3)
    diff = np.abs(img.astype(np.int32) - jimg.astype(np.int32))
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert (diff.max(-1) <= 2).mean() >= 0.9999 and diff.max() <= 32, diff.max()
    np.testing.assert_allclose(ds._joints, ref["ref/joints"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ds._obj_pose, ref["ref/obj_pose"], atol=5e-6, rtol=0)
    np.testing.assert_allclose(ds._hand_pose, ref["ref/hand_pose"], atol=5e-6, rtol=0)
    assert len(ds) == 16 and raster_rgb.launches == 0  # the CPU path runs the twin


def _part(rng, n, keys, is_synth):
    from artiboost_torch.datasets.hoquery import Queries, SynthQueries

    shapes = {Queries.IMAGE: (4, 4, 3), Queries.JOINTS_3D: (21, 3), Queries.ROOT_JOINT: (3,),
              Queries.HAND_POSE: (48,), Queries.OBJ_VERTS_3D: (5, 3)}
    part = {k: rng.randn(n, *shapes[k]).astype(np.float32) for k in keys}
    part[SynthQueries.IS_SYNTH] = np.full((n,), is_synth, np.int32)
    part[SynthQueries.OBJ_ID] = rng.randint(0, 4, n).astype(np.int32)
    part[Queries.SAMPLE_IDX] = np.arange(n, dtype=np.int32)
    return part


UNION_CASES = {
    "same_keys": (("image", "joints_3d", "root_joint"), ("image", "joints_3d", "root_joint")),
    "real_lacks_mano": (("image", "joints_3d", "root_joint"),
                        ("image", "joints_3d", "root_joint", "hand_pose")),
    "each_lacks_one": (("image", "root_joint", "obj_verts_3d"),
                       ("image", "root_joint", "hand_pose")),
}


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_union_concat_against_jax(case):
    import jax.numpy as jnp

    from artiboost_torch.utils import batching as tb
    from artiboost_tpu.utils import batching as jb

    rng = np.random.RandomState(0)
    ka, kb = UNION_CASES[case]
    a, b = _part(rng, 3, ka, 0), _part(rng, 2, kb, 1)
    del b["obj_id"]  # an id key filled with -1
    ref = jb.union_concat([{k: jnp.asarray(v) for k, v in p.items()} for p in (a, b)])
    got = tb.union_concat([{k: torch.from_numpy(v) for k, v in p.items()} for p in (a, b)])
    assert set(got) == set(ref)
    for k in ref:
        if k == tb.KEY_VALID:
            assert set(got[k]) == set(ref[k])
            for m in ref[k]:
                np.testing.assert_array_equal(got[k][m].numpy(), np.asarray(ref[k][m]))
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # a third part over the union of the first two: masks compose
    c = _part(rng, 2, kb, 1)
    ref3 = jb.union_concat([ref, {k: jnp.asarray(v) for k, v in c.items()}])
    got3 = tb.union_concat([got, {k: torch.from_numpy(v) for k, v in c.items()}])
    for m in ref3.get(jb.KEY_VALID, {}):
        np.testing.assert_array_equal(got3[tb.KEY_VALID][m].numpy(), np.asarray(ref3[jb.KEY_VALID][m]))
    mask = tb.key_validity(got3, "hand_pose", "root_joint")
    jmask = jb.key_validity(ref3, "hand_pose", "root_joint")
    assert (mask is None) == (jmask is None)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        vals = rng.rand(len(mask)).astype(np.float32)
        np.testing.assert_allclose(
            float(tb.masked_sample_mean(torch.from_numpy(vals), mask)),
            float(jb.masked_sample_mean(jnp.asarray(vals), jmask)), rtol=1e-6)


def test_union_concat_promotes_bf16_image():
    """The synth half is bf16 under IMAGE_BF16 (loader.py:178); the union
    with a float32 real half is float32, the bf16 values exact in it."""
    from artiboost_torch.utils.batching import union_concat

    real = {"image": torch.rand(2, 4, 4, 3)}
    synth = {"image": torch.rand(3, 4, 4, 3).to(torch.bfloat16)}
    out = union_concat([real, synth])
    assert out["image"].dtype == torch.float32
    assert torch.equal(out["image"][2:], synth["image"].float())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_synthetic(sys.argv[1])
