"""The pipelined train step (``TRAIN.PIPELINE_SYNTH``, JAX
``train/train_artiboost.py:71-87``, ``:321-326``) against the unpipelined
order, on the CPU.

- ``run`` on ``config/synthetic_smoke.yaml`` cut to batch 4 at 64 x 64 (3
  synth-only steps an epoch, 2 epochs, a val sweep of 2 batches): the
  pipelined run renders step N+1's synth half before step N's train step,
  and equals the unpipelined run bit for bit: every step's loss, the
  parameters and BatchNorm buffers after the run, the CCV weight map and
  the loader's generator state. The same with a real half (a SyntheticHO
  train split: 2 real + 2 synth a step).
- ``PIPELINE_SYNTH`` absent means pipelined.
- The ordinal losses, whose pair tables now live on the draws' device,
  give the bits of the host-side indexing they replace, and hold against
  the JAX criterion on the same draws within rtol 1e-5 (the bound of
  ``tests/test_torch_train.py``).
"""
import copy
from itertools import combinations, product

import numpy as np
import pytest
import torch

from artiboost_torch import train
from artiboost_torch.artiboost.loader import ArtiBoostLoader
from artiboost_torch.parallel.train_state import TrainStep
from artiboost_torch.utils.config import load_config

SMOKE = "config/synthetic_smoke.yaml"


def small_config(real: bool) -> dict:
    """synthetic_smoke.yaml at batch 4, 64 x 64, a 128 x 128 render and
    32-wide deconvs: synth-only (CONFIG_LEN_TRAIN 12: 3 steps) or with 8
    SyntheticHO train samples (CONFIG_LEN_TRAIN 8: 4 steps of 2 + 2);
    VAL_LEN 8 (2 val batches); no TEST split."""
    cfg = load_config(SMOKE)
    del cfg["DATASET"]["TEST"]
    if real:
        cfg["DATASET"]["TRAIN"].update(N_SAMPLES=8, RAW_SIZE=64)
        cfg["MANAGER"].update(CONFIG_LEN_TRAIN=8, VAL_LEN=8)
    else:
        del cfg["DATASET"]["TRAIN"]
        cfg["MANAGER"].update(CONFIG_LEN_TRAIN=12, VAL_LEN=8)
    cfg["MANAGER"]["RENDERER"].update(RENDER_SIZE=[128, 128],
                                      CAM_PARAM={"FX": 218.0, "FY": 218.0, "CX": 64.0,
                                                 "CY": 64.0})
    cfg["DATA_PRESET"].update(IMAGE_SIZE=[64, 64], HEATMAP_SIZE=[8, 8])
    cfg["ARCH"]["HYBRID_HEAD"].update(NUM_DECONV_FILTERS=[32, 32], DEPTH_RESOLUTION=8)
    cfg["TRAIN"].update(BATCH_SIZE=4, EVAL_FREQ=1, VAL_START_EPOCH=0)
    return cfg


def _run(cfg, pipeline, monkeypatch):
    """``run`` for 2 epochs -> (its result, the order of synth renders and
    train steps)."""
    cfg = copy.deepcopy(cfg)
    cfg["TRAIN"]["PIPELINE_SYNTH"] = pipeline
    calls = []
    synth_part, step_call = ArtiBoostLoader.synth_part, TrainStep.__call__

    def spy_synth(self, sidx):
        calls.append("render")
        return synth_part(self, sidx)

    def spy_step(self, batch, draws):
        calls.append("train")
        return step_call(self, batch, draws)

    with monkeypatch.context() as m:
        m.setattr(ArtiBoostLoader, "synth_part", spy_synth)
        m.setattr(TrainStep, "__call__", spy_step)
        out = train.run(cfg, epochs=2, device="cpu", test_freq=0)
    return out, calls


@pytest.mark.parametrize("real", [False, True], ids=["synth_only", "real_half"])
def test_pipelined_epoch_equals_unpipelined(real, monkeypatch):
    cfg = small_config(real)
    got, order = _run(cfg, True, monkeypatch)
    want, plain_order = _run(cfg, False, monkeypatch)
    steps = len(got["loader"])
    assert steps == (4 if real else 3)
    assert got["loader"]._mixed_counts() == ((2, 2) if real else (0, 4))
    # the pipelined order: render N+1 comes before train N
    assert plain_order[:2 * steps] == ["render", "train"] * steps
    assert order[:2 * steps] == ["render"] + ["render", "train"] * (steps - 1) + ["train"]
    for g, w in zip(got["history"], want["history"]):
        assert len(g["train"]["final_loss"]) == steps
        assert g["train"]["final_loss"] == w["train"]["final_loss"]  # bit for bit
        assert g["val"]["measures"] == w["val"]["measures"]
    g_state, w_state = got["model"].state_dict(), want["model"].state_dict()
    assert list(g_state) == list(w_state)
    for k in w_state:
        assert torch.equal(g_state[k], w_state[k]), k
    g_opt, w_opt = got["step"].optimizer.state_dict(), want["step"].optimizer.state_dict()
    for i, st in w_opt["state"].items():
        for k, v in st.items():
            assert torch.equal(g_opt["state"][i][k], v), (i, k)
    assert torch.equal(got["loader"].ccv.sample_weight_map, want["loader"].ccv.sample_weight_map)
    assert not bool(torch.all(got["loader"].ccv.sample_weight_map == 1.0))  # the reweight ran
    assert torch.equal(got["loader"].generator.get_state(), want["loader"].generator.get_state())


def test_pipeline_synth_defaults_to_on(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def spy(*a, pipeline, **k):
        seen.append(pipeline)
        raise Stop

    monkeypatch.setattr(train, "train_epoch", spy)
    cfg = small_config(False)
    assert "PIPELINE_SYNTH" not in cfg["TRAIN"]
    for value, want in ((None, True), (False, False), (True, True)):
        c = copy.deepcopy(cfg)
        if value is not None:
            c["TRAIN"]["PIPELINE_SYNTH"] = value
        with pytest.raises(Stop):
            train.run(c, epochs=1, device="cpu", test_freq=0)
        assert seen[-1] is want


def _ordinal_inputs(rng, B=6):
    preds = {"joints_3d_abs": (rng.randn(B, 21, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32),
             "corners_3d_abs": (rng.randn(B, 8, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)}
    targs = {"joints_3d": (rng.randn(B, 21, 3) * 0.05).astype(np.float32),
             "corners_3d": (rng.randn(B, 8, 3) * 0.05).astype(np.float32),
             "root_joint": (rng.randn(B, 3) * 0.01 + [0, 0, 0.5]).astype(np.float32),
             "joints_vis": (rng.rand(B, 21) > 0.2).astype(np.float32),
             "corners_vis": (rng.rand(B, 8) > 0.2).astype(np.float32)}
    return preds, targs


def _host_indexed(name, loss, preds, targs, draws):
    """The losses as the port computed them before: the pair tables on the
    host, indexed by the draws moved there."""
    t = {k: torch.from_numpy(v) for k, v in targs.items()}
    p = {k: torch.from_numpy(v) for k, v in preds.items()}
    view = draws["view"]

    def pairs(kp, idx):
        return torch.cat([kp[:, idx[:, 0]], kp[:, idx[:, 1]]], dim=2)

    def rel(x):
        return torch.einsum("bpk,vk->bpv", x[..., :3] - x[..., 3:], view)

    if name == "HandOrdLoss":
        vis = t["joints_vis"]
        pj, tj = p["joints_3d_abs"] * vis[..., None], \
            (t["joints_3d"] + t["root_joint"][:, None]) * vis[..., None]
        jidx = torch.tensor(list(combinations(range(21), 2)))[draws["sel_j"].cpu()]
        jl = torch.mean(torch.log1p(torch.relu(-torch.sign(rel(pairs(tj, jidx)))
                                               * rel(pairs(pj, jidx)))))
        parents = torch.tensor([0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17,
                                18, 19])

        def parts(j):
            return (j - j[:, parents])[:, 1:]

        pidx = torch.tensor(list(combinations(range(20), 2)))[draws["sel_p"].cpu()]

        def prel(x):
            return torch.einsum("bpk,vk->bpv", torch.linalg.cross(x[..., :3], x[..., 3:], dim=-1),
                                view)

        pl = torch.mean(torch.relu(-torch.sign(prel(pairs(parts(tj), pidx)))
                                   * prel(pairs(parts(pj), pidx))))
        return jl + pl
    root = t["root_joint"][:, None]
    jv, cv = t["joints_vis"][..., None], t["corners_vis"][..., None]
    idx = torch.tensor(list(product(range(21), range(8))))[draws["sel"].cpu()]
    pp = torch.cat([(p["joints_3d_abs"] * jv)[:, idx[:, 0]],
                    (p["corners_3d_abs"] * cv)[:, idx[:, 1]]], dim=2)
    tp = torch.cat([((t["joints_3d"] + root) * jv)[:, idx[:, 0]],
                    ((t["corners_3d"] + root) * cv)[:, idx[:, 1]]], dim=2)
    return torch.mean(torch.log1p(torch.relu(-torch.sign(rel(tp)) * rel(pp))))


@pytest.mark.parametrize("name", ["HandOrdLoss", "SceneOrdLoss"])
def test_ordinal_tables_on_the_device(name):
    import jax
    import jax.numpy as jnp
    from test_torch_train import jax_ordinal_draws

    from artiboost_torch.criterions import ordinal as t_ord
    from artiboost_tpu.criterions import ordinal as j_ord

    rng = np.random.RandomState(4)
    preds, targs = _ordinal_inputs(rng)
    jloss, tloss = getattr(j_ord, name)(), getattr(t_ord, name)()
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jd = jax_ordinal_draws(jax, key, jloss)  # the draws JAX's loss makes from key
        draws = {k: torch.from_numpy(np.asarray(v).astype(np.int64 if k != "view" else np.float32))
                 for k, v in jd.items()}
        final, terms = tloss({k: torch.from_numpy(v) for k, v in preds.items()},
                             {k: torch.from_numpy(v) for k, v in targs.items()}, draws)
        assert torch.equal(final, _host_indexed(name, tloss, preds, targs, draws)), seed
        jfinal, _ = jloss({k: jnp.asarray(v) for k, v in preds.items()},
                          {k: jnp.asarray(v) for k, v in targs.items()}, key)
        np.testing.assert_allclose(float(final), float(jfinal), rtol=1e-5, atol=0)
        assert float(final) > 0
    # the view vectors begin with the camera ray, filled on the device
    view = t_ord.sample_view_vectors(torch.Generator().manual_seed(0), 5, "cpu")
    assert view.shape == (6, 3) and view[0].tolist() == [0.0, 0.0, 1.0]
