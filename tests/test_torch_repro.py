"""The same seed gives the same run: the port's triplet draw with
replacement (``ccv.sample_triplets_draws``, an inverse CDF over fixed-point
weights) and the deterministic forms of the port's float accumulations.

- The draw against Categorical(weights) by a chi-square (p > 1e-3 on a
  fixed seed), with and without blacklisted cells, and against JAX's
  ``sample_triplets`` (a threefry Gumbel-max) on the same numpy weight map
  by a two-sample chi-square (p > 1e-3): the two never share bits, so they
  are held by distribution.
- Its ids depend only on the weights' bits and the generator's state:
  equal ids (exactly) whether the weights arrive contiguous, as a strided
  view, or summed in another order to the same bits; no
  ``torch.multinomial``; a weight of 0 is never drawn.
- ``ops/rasterizer.vertex_normals`` (one ``index_put_`` with accumulate,
  which a card runs in one order) against JAX's ``vertex_normals`` (atol
  1e-6 on unit normals: float32 sums of the same terms in another order)
  and against the incidence-table form ``vertex_normals_indexed`` (the
  same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from artiboost_torch.artiboost import ccv as t_ccv
from artiboost_torch.ops import rasterizer as t_raster
from artiboost_tpu.artiboost import ccv as j_ccv
from artiboost_tpu.ops import rasterizer as j_raster

SHAPE = (2, 3, 4)
BLACKLISTED = [1, 7, 13]


def weight_map(blacklist: bool, seed: int = 4):
    rng = np.random.RandomState(seed)
    w = (rng.rand(*SHAPE) * 3 + 0.2).astype(np.float32)
    bl = np.zeros_like(w)
    if blacklist:
        bl.reshape(-1)[BLACKLISTED] = 1.0
    return w, bl


def torch_space(w: np.ndarray, bl: np.ndarray) -> t_ccv.CCVSpace:
    space = t_ccv.init_ccv_space(*SHAPE, torch.from_numpy(bl), device="cpu")
    return space._replace(sample_weight_map=torch.from_numpy(w))


def draw(space, seed: int, n: int) -> torch.Tensor:
    return t_ccv.sample_triplets_draws(space, torch.Generator().manual_seed(seed), n)


@pytest.mark.parametrize("blacklist", [False, True])
def test_draw_is_categorical(blacklist):
    w, bl = weight_map(blacklist)
    n = 40000
    counts = np.bincount(draw(torch_space(w, bl), 0, n).numpy(), minlength=w.size)
    keep = bl.reshape(-1) == 0
    assert counts[~keep].sum() == 0
    p = w.reshape(-1).astype(np.float64)[keep]
    assert stats.chisquare(counts[keep], p / p.sum() * n).pvalue > 1e-3


def test_draw_against_jax():
    w, bl = weight_map(True)
    n = 20000
    port = np.bincount(draw(torch_space(w, bl), 1, n).numpy(), minlength=w.size)
    space = j_ccv.init_ccv_space(*SHAPE, jnp.asarray(bl))._replace(
        sample_weight_map=jnp.asarray(w))
    oid, vid, gid, _ = j_ccv.sample_triplets(space, jax.random.PRNGKey(2), n, replace=True)
    flat = np.asarray(j_ccv.ovg_to_flat(oid, vid, gid, SHAPE[1], SHAPE[2]))
    ref = np.bincount(flat, minlength=w.size)
    keep = bl.reshape(-1) == 0
    assert port[~keep].sum() == 0 and ref[~keep].sum() == 0
    _, pvalue, _, _ = stats.chi2_contingency(np.stack([port[keep], ref[keep]]))
    assert pvalue > 1e-3


def _contiguous(w):
    return torch.from_numpy(w)


def _strided(w):
    # the same values as a view into a larger buffer, every other element
    buf = torch.zeros((2,) + w.shape).transpose(0, -1).contiguous().transpose(0, -1)
    buf[0] = torch.from_numpy(w)
    view = buf[0]
    assert not view.is_contiguous()
    return view


def _summed_other_order(w):
    # w as the sum of three parts added in another order: the same bits here
    # (the parts are exact binary fractions of w), so the same ids
    t = torch.from_numpy(w).double()
    a, b = t * 0.5, t * 0.25
    out = ((b + (t - a - b)) + a).float()
    assert torch.equal(out, torch.from_numpy(w))
    return out


@pytest.mark.parametrize("form", [_contiguous, _strided, _summed_other_order])
def test_draw_depends_only_on_bits(form):
    w, bl = weight_map(True, seed=9)
    ref = draw(torch_space(w, bl), 5, 3000)
    space = t_ccv.init_ccv_space(*SHAPE, torch.from_numpy(bl), device="cpu")
    got = draw(space._replace(sample_weight_map=form(w)), 5, 3000)
    assert torch.equal(got, ref)


def test_draw_without_multinomial(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("torch.multinomial called")

    monkeypatch.setattr(torch, "multinomial", refuse)
    w, bl = weight_map(True)
    assert draw(torch_space(w, bl), 0, 100).shape == (100,)


def test_zero_weight_never_drawn():
    # weights of 0, and weights below the fixed point's resolution
    # (2^-40 of the largest), beside a dominant one
    w = np.full(SHAPE, 1e-13, np.float32)
    w.reshape(-1)[[3, 17]] = 0.0
    w.reshape(-1)[[0, 5, 11]] = [10.0, 1e-3, 1.0]
    bl = np.zeros_like(w)
    bl.reshape(-1)[0] = 1.0  # the largest sample weight, blacklisted
    q = t_ccv.fixed_point_weights(torch_space(w, bl).effective_weights().reshape(-1))
    assert set(torch.nonzero(q).reshape(-1).tolist()) == {5, 11}
    counts = np.bincount(draw(torch_space(w, bl), 3, 200000).numpy(), minlength=w.size)
    assert set(np.nonzero(counts)[0].tolist()) == {5, 11}
    assert counts[5] > 0  # drawn about 1e-3 of the time


def test_fixed_point_fits_int64():
    # 2^40 of resolution unless the sum of N cells at the largest weight
    # would pass 2^62
    big = t_ccv.fixed_point_weights(torch.ones(1 << 23))
    assert int(big[0]) == 2 ** (62 - 24) and int(big.sum()) < 2 ** 62
    assert int(t_ccv.fixed_point_weights(torch.ones(57600))[0]) == 2 ** 40


def test_vertex_normals_against_jax():
    rng = np.random.RandomState(0)
    B, V, F = 3, 40, 120
    verts = rng.randn(B, V, 3).astype(np.float32)
    faces = rng.randint(0, V, (B, F, 3))
    got = t_raster.vertex_normals(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    ref = np.stack([np.asarray(j_raster.vertex_normals(jnp.asarray(verts[b]),
                                                       jnp.asarray(faces[b])))
                    for b in range(B)])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    D = max(t_raster.build_face_incidence(faces[b], V).shape[1] for b in range(B))
    inc = np.stack([t_raster.build_face_incidence(faces[b], V, D) for b in range(B)])
    indexed = t_raster.vertex_normals_indexed(torch.from_numpy(verts), torch.from_numpy(faces),
                                              torch.from_numpy(inc)).numpy()
    np.testing.assert_allclose(got, indexed, atol=1e-6, rtol=0)


def _checkpoint(run_dir):
    """A run's last checkpoint (``latest.pt`` and the ArtiBoost state) as
    named leaves (tensors, and the optimizer's settings)."""
    ckpt_dir = next(run_dir.glob("exp/*/checkpoints"))
    payload = torch.load(ckpt_dir / "latest.pt", map_location="cpu", weights_only=False)

    def leaves(tree, name):
        if isinstance(tree, dict):
            return [x for k in sorted(tree, key=str) for x in leaves(tree[k], f"{name}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{name}/{i}")]
        return [(name, torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree)]

    with np.load(ckpt_dir / "artiboost_latest.npz") as npz:
        ab = {k: np.array(npz[k]) for k in npz.files}
    return dict(leaves(payload, "") + leaves(ab, "artiboost"))


RUN = """
import sys
from artiboost_torch import train
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.recorder import Recorder
cfg = load_config(sys.argv[1])
train.run(cfg, epochs=1, device="cpu", recorder=Recorder("default", cfg), test_freq=0)
"""


def test_two_processes_same_checkpoint(tmp_path):
    """``train.run`` with the entry point's recorder (the summarizer, which
    imports TensorBoard, left out) in two fresh processes from one seed (the
    smoke config without its datasets, 1 epoch of 2 steps of 8 and a val
    batch, on the CPU): every leaf of the two checkpoints is the same bits,
    torch's RNG states included (torch seeds its CPU generator differently
    in every process; the run seeds it from MANUAL_SEED)."""
    import subprocess
    import sys
    from pathlib import Path

    import yaml

    from artiboost_torch.utils.config import load_config
    from tests._proc import subprocess_env

    repo = Path(__file__).resolve().parents[1]
    cfg = load_config(str(repo / "config" / "synthetic_smoke.yaml"))
    cfg["DATASET"] = {}
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=16, VAL_LEN=8)
    cfg["TRAIN"].update(BATCH_SIZE=8, EVAL_FREQ=1, VAL_START_EPOCH=0)
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["MANAGER"]["RENDERER"].update(RENDER_SIZE=[128, 128],
                                      CAM_PARAM={"FX": 217.5, "FY": 217.5, "CX": 64.0,
                                                 "CY": 64.0})
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    env = subprocess_env()
    procs = []
    for i in range(2):
        (tmp_path / str(i)).mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RUN, str(tmp_path / "tiny.yaml")], cwd=tmp_path / str(i),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    a, b = (_checkpoint(tmp_path / str(i)) for i in range(2))
    assert sorted(a) == sorted(b) and "/rng_cpu" in a
    same = [torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
            for k in a]
    assert [k for k, eq in zip(a, same) if not eq] == []
