"""Data parallelism on the CPU: two gloo ranks
(``tests/test_torch_dist_worker.py``) train ``config/synthetic_smoke.yaml``
cut small through the entry point
(``python -m artiboost_torch.train --multihost``), against the same run in
one process; the global BatchNorm against BatchNorm over the whole batch;
a two-rank ``--resume``; the loader's roundings against JAX's
``ArtiBoostLoader`` on a two-device mesh.

Tolerances:
- across the two ranks everything is bit-equal: parameters, BatchNorm
  buffers, Adam's moments, the CCV weight and occurrence maps, the
  loader's generator state, every reported figure;
- the global BatchNorm within 2e-6 of ``F.batch_norm`` over the
  concatenated batch (outputs, input gradients, weight and bias
  gradients, running statistics): float32 sums in another order;
- the two-rank run against one rank on the same global batches, after
  one epoch of 2 Adam steps at lr 1e-4 with GRAD_CLIP 1e-3: each step's
  loss within 1e-5 relative (measured 7.5e-7); every parameter within
  2 lr a step (Adam moves a weight by about lr whatever its gradient's
  size, so where the clipped gradient is near 0 float noise can flip a
  step), 99.9 % of them within 1e-6 and 99 % within 1e-7 (measured: the
  largest 1.5e-5, 7.4e-5 of them beyond 1e-6, 0.44 % beyond 1e-7); the
  val and TEST measures within 1e-3 relative and the weight map within
  1e-5 (measured 1.6e-6 to 5.4e-6). The ranks render their rows of the
  same draws, so the inputs are the same bits; the conv and BatchNorm
  reductions run over 4 rows in place of 8;
- a resumed rank restores the saved state bit for bit;
- the roundings are integers, equal.

Each rank's process has a communicate timeout of 150 s and its process
group a 120 s timeout."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from artiboost_torch import train
from artiboost_torch.artiboost import loader as t_loader
from artiboost_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
SMOKE = REPO / "config" / "synthetic_smoke.yaml"
BATCH = 8
RANK_TIMEOUT_S = 150


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def small_config(path) -> dict:
    """synthetic_smoke.yaml at 64 x 64 with 32-wide deconvs: 8 SyntheticHO
    train samples and CONFIG_LEN_TRAIN 8 (2 steps of 4 real + 4 synth),
    VAL_LEN 16 (2 val batches), a TEST split of 12 (a batch of 8 and a tail
    of 4 padded to 8)."""
    cfg = load_config(str(SMOKE))
    cfg["DATASET"]["TRAIN"].update(N_SAMPLES=8, RAW_SIZE=64)
    cfg["DATASET"]["TEST"].update(N_SAMPLES=12, RAW_SIZE=64)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=8, VAL_LEN=16)
    cfg["MANAGER"]["RENDERER"].update(RENDER_SIZE=[128, 128],
                                      CAM_PARAM={"FX": 218.0, "FY": 218.0, "CX": 64.0,
                                                 "CY": 64.0})
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["ARCH"]["HYBRID_HEAD"].update(NUM_DECONV_FILTERS=[32, 32], DEPTH_RESOLUTION=8)
    cfg["TRAIN"]["BATCH_SIZE"] = BATCH
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


@pytest.mark.parametrize("config_len_train,opg,val_len,real_len", [
    (24, 10, 24, 0), (10, 16, 10, 0), (40, 16, 21, 24), (24, 10, 35, 10), (7, 3, 5, 100)])
def test_roundings_against_jax(config_len_train, opg, val_len, real_len):
    """The port's four roundings at world size 2 against the JAX loader on
    a 2-device mesh (``get_mesh(n_data=2)``), including lengths that do
    not tile it (tests/test_artiboost.py:409-420's 24 and 10)."""
    from artiboost_tpu.artiboost.loader import ArtiBoostLoader as JLoader
    from artiboost_tpu.parallel.mesh import get_mesh

    class _Real:
        def __len__(self):
            return real_len

    batch = 8
    cfg = {"CONFIG_LEN_TRAIN": config_len_train, "OPG_BATCH_SIZE": opg, "VAL_LEN": val_len,
           "FILTER": {"BACK": False},
           "OBJ_ENGINE": {"OBJ": ["synthobj_0", "synthobj_1"]}, "GRASP_ENGINE": {"GRASP_NUM": 4},
           "VIEW_ENGINE": {"PERSP_U_BINS": 2, "PERSP_THETA_BINS": 2}}
    jl = JLoader(real_dataset=_Real() if real_len else None, cfg=cfg, batch_size=batch,
                 mesh=get_mesh(n_data=2))
    assert t_loader.round_len_train(config_len_train, 2) == jl.config_len_train
    assert t_loader.mixed_counts(batch, real_len, jl.config_len_train, 2) == jl._mixed_counts()

    chunks, counts = [], []
    jl._generate_jit = lambda key, o, v, g: (chunks.append(int(o.shape[0])),
                                              {"obj_id": jnp.zeros(o.shape[0])})[1]
    jl._generate_poses(*(jnp.arange(jl.config_len_train),) * 3, jax.random.PRNGKey(0))
    assert t_loader.sweep_chunk(jl.config_len_train, opg, 2) == chunks[0]
    jl._generate_poses = lambda oid, vid, gid, key: counts.append(int(oid.shape[0]))
    jl.prepare_val()
    n_valid = 2 * 4 * 4
    assert t_loader.val_count(val_len, n_valid, batch, 2) == counts[0]


@pytest.mark.parametrize("device_type,hosts,rank,want", [
    ("cuda", [("a", 4)] * 4 + [("b", 4)] * 4, 5, ("nccl", 1, 4)),  # 2 hosts x 4 cards
    ("cuda", [("a", 1)] * 2, 1, ("gloo", 1, 2)),  # two ranks share one card
    ("cuda", [("a", 8)] * 2 + [("b", 1)] * 2, 1, ("gloo", 1, 2)),  # one host short of cards
    ("cuda", [("a", 0)], 0, ("gloo", 0, 1)),
    ("cpu", [("a", 4)] * 2 + [("b", 4)], 2, ("gloo", 0, 1)),
])
def test_backend_choice(device_type, hosts, rank, want):
    """``--coordinator`` ranks tell each other their host and cards: a rank's
    card is its index among its host's ranks, and NCCL runs only when every
    host has a card for each of its ranks, the same choice on every rank."""
    from artiboost_torch.parallel.mesh import choose_backend

    assert choose_backend(device_type, hosts, rank) == want
    assert {choose_backend(device_type, hosts, r)[0] for r in range(len(hosts))} == {want[0]}


def test_blacklist_build_has_margin():
    """The released recipe's blacklist is far from its threshold: the least
    |dot_z - threshold| is 3.0e-5 (about 500 float32 ulps at 0.8), where a
    float32 build on any device rounds within a few ulps, so every card and
    every run builds the float64 map's bits and ranks that each build their
    own agree (measured: the float32 map equals the float64 one)."""
    from tests.test_torch_dist_witness import released_blacklist

    m32, m64, margin = released_blacklist("cpu")
    assert margin >= 1e-5
    assert torch.equal(m32, m64)


@pytest.mark.parametrize("cut", ["empty", "header", "half"])
def test_blacklist_cache_partial_read(tmp_path, cut):
    """A reader that races a writer writing the cache in place finds a file
    cut short; ``np.load`` then raises: such a race fails a rank, it never
    hands it another map."""
    import io

    buf = io.BytesIO()
    np.save(buf, (np.arange(4 * 288 * 50) % 7 == 0).astype(np.float32).reshape(4, 288, 50))
    data = buf.getvalue()
    path = tmp_path / "map.npy"
    path.write_bytes(data[:{"empty": 0, "header": 64, "half": len(data) // 2}[cut]])

    def build():
        raise AssertionError("the cache file exists: nothing is built")

    with pytest.raises((ValueError, EOFError)):
        t_loader.cached_blacklist(str(path), build, "cpu")


def test_blacklist_cache_shared_by_racing_ranks(tmp_path):
    """Sixteen callers start together on a cache that is not there yet,
    twenty times over: each finds no file and builds and renames its own
    into place, or reads one whole; every call returns the same bits."""
    import threading

    want = (torch.arange(4 * 288 * 50) % 7 == 0).float().reshape(4, 288, 50)
    got, errors = [], []

    def call(path, start):
        start.wait()
        try:
            got.append(t_loader.cached_blacklist(path, want.clone, "cpu"))
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    for i in range(20):
        start = threading.Barrier(16)
        threads = [threading.Thread(target=call, args=(str(tmp_path / str(i) / "map.npy"), start))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors[:3]
    assert len(got) == 20 * 16 and all(torch.equal(g, want) for g in got)


@pytest.fixture(scope="module", autouse=True)
def _ranks(tmp_path_factory):
    """Both ranks, started with the file so they run beside its other tests."""
    d = tmp_path_factory.mktemp("dist")
    cfg = small_config(d / "small.yaml")
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "test_torch_dist_worker.py"),
                               str(r), *ports, str(d), str(d / "small.yaml"),
                               str(d / f"rank{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    yield d, cfg, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def dist_run(_ranks):
    """The one-rank run of the same config in this process, then both
    ranks' records."""
    d, cfg, procs = _ranks
    cwd = os.getcwd()
    os.chdir(d / "..")
    try:
        single = train.run(cfg, epochs=1, device="cpu", test_freq=1)
    finally:
        os.chdir(cwd)
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode())
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "single": single}


def test_global_batchnorm(dist_run):
    """Each rank's rows through the global BatchNorm, gathered, equal
    BatchNorm over the concatenated batch; the input gradients are those of
    the sum of the ranks' losses, the weight and bias gradients (averaged
    over ranks, as the train step does) those of their mean."""
    from torch.nn import functional as F

    from test_torch_dist_worker import BN_SHAPE

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 1).requires_grad_(True)
    c = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32))
    w = torch.linspace(0.5, 1.5, BN_SHAPE[1]).requires_grad_(True)
    b = torch.linspace(-0.2, 0.2, BN_SHAPE[1]).requires_grad_(True)
    y = F.batch_norm(x, None, None, w, b, training=True, eps=1e-5)
    half = BN_SHAPE[0] // 2
    losses = [torch.mean(y[s:s + half] * c[s:s + half]) for s in (0, half)]
    dx, = torch.autograd.grad(sum(losses), x, retain_graph=True)
    dw, db = torch.autograd.grad(sum(losses) / 2, (w, b))
    xf = x.detach()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
    for r in dist_run["ranks"]:
        bn = r["bn"]
        for got, want in ((bn["y"], y), (bn["dx"], dx), (bn["dweight"], dw), (bn["dbias"], db),
                          (bn["running_mean"], 0.1 * mean),
                          (bn["running_var"], 0.9 + 0.1 * var)):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=2e-6, rtol=2e-6)


def test_ranks_bit_equal(dist_run):
    r0, r1 = dist_run["ranks"]
    for run in ("first", "saved", "restored"):
        a, b = r0[run], r1[run]
        for k in ("params", "buffers", "optimizer", "step", "sample_weight_map",
                  "occurrence_map", "rng_state"):
            assert a[k] == b[k], (run, k)
    for k in ("final_loss", "measures", "images", "val_images"):
        assert r0["first"][k] == r1["first"][k], k
    first = r0["first"]
    assert len(first["final_loss"]) == 2 and first["images"] == 2 * BATCH
    assert first["val_images"] == 16


def test_two_ranks_against_one(dist_run):
    first, single = dist_run["ranks"][0]["first"], dist_run["single"]
    hist = single["history"][0]
    want_loss = np.array([float(v) for v in hist["train"]["final_loss"]])
    np.testing.assert_allclose(first["final_loss"], want_loss, rtol=1e-5)
    for split in ("train", "val", "test"):
        for metric, vals in hist[split]["measures"].items():
            for k, v in vals.items():
                np.testing.assert_allclose(first["measures"][split][metric][k], v, rtol=1e-3,
                                           err_msg=f"{split} {metric} {k}")
    sd = single["model"].state_dict()
    diff = torch.cat([(v - sd[k]).abs().flatten() for k, v in first["model"].items()
                      if v.dtype.is_floating_point])
    lr, steps = float(single["step"].schedule(0)), single["step"].step
    assert float(diff.max()) <= 2 * lr * steps
    assert float((diff <= 1e-6).float().mean()) >= 0.999
    assert float((diff <= 1e-7).float().mean()) >= 0.99
    w = single["loader"].ccv.sample_weight_map
    np.testing.assert_allclose(first["weight_map"].numpy(), w.numpy(), atol=1e-5, rtol=0)
    assert float((w != 1.0).float().mean()) > 0  # the reweight moved the map


def test_resume_restores_every_rank(dist_run):
    """--resume on both ranks: each restores the checkpoint rank 0 saved,
    bit for bit."""
    for r in dist_run["ranks"]:
        assert r["restored"]["epoch"] == 1
        for k in ("params", "buffers", "optimizer", "step", "sample_weight_map",
                  "occurrence_map", "rng_state"):
            assert r["restored"][k] == r["saved"][k], k
