"""The slice as a whole: ``artiboost_torch.train.run`` (SyntheticHO real
half, mixed real+synth batches, the train step, the evaluator, mining)
against the JAX package's train loop (``train/train_artiboost.py:342-367``
with the pipelined mixed step) on config/synthetic_smoke.yaml cut to four
steps, on the CPU.

Every random draw of the JAX run (triplet ids, pose draws, the epoch's
permutation seeds, synth draws and criterion draws per step) is recorded
and replayed into the port, and the model starts from the JAX
initialisation. The JAX side runs in a subprocess with
``--xla_cpu_max_isa=AVX`` (separately rounded a*b+c, see
tests/test_torch_raster.py). Tolerances are stated in the test."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._proc import NO_FMA, subprocess_env, time_left
from tests.test_torch_train import CFG_PATH, jax_loss_draws, jax_ordinal_draws


def slice_config(cache_dir):
    """config/synthetic_smoke.yaml cut to a few steps: SyntheticHO with 32
    samples at 128 x 128, CONFIG_LEN_TRAIN 32 (so 8 real + 8 synth per batch
    of 16 and 4 steps), one epoch, and no VAL_LEN, so mining reads the train
    epoch's measurements (the val sweep and the mining after it are held in
    tests/test_torch_slice.py)."""
    from artiboost_torch.utils.config import load_config

    cfg = load_config(CFG_PATH)
    cfg["DATASET"]["TRAIN"].update(N_SAMPLES=32, RAW_SIZE=128)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=32, CACHE_DIR=str(cache_dir))
    del cfg["MANAGER"]["VAL_LEN"]
    return cfg


def real_dataset(base, cfg):
    """The real half on the JAX side: the JAX package's HODataset pipeline
    (its numpy geometry and native image path) over the images and
    annotations of the port's SyntheticHO for the cut config, which ``run``
    rebuilds bit for bit from the same seed. SyntheticHO itself is held
    against the JAX one in tests/test_torch_data.py."""
    from artiboost_torch.datasets.synthetic import build_dataset
    from tests.test_torch_data import _accessors

    ds = build_dataset(cfg["DATASET"]["TRAIN"], cfg["DATA_PRESET"], device="cpu")
    fx = {"images": ds.images.numpy(), "intr": ds._intr, "raw": ds.raw_size[0],
          "joints": ds._joints, "corners_can": ds._corners_can, "obj_pose": ds._obj_pose,
          "obj_verts_can": ds._obj_verts_can, "hand_verts": ds._hand_verts,
          "hand_pose": ds._hand_pose, "hand_shape": ds._hand_shape, "obj_id": ds._obj_id}
    node = {k: v for k, v in cfg["DATASET"]["TRAIN"].items() if k != "TYPE"}
    return _accessors(base, fx, "right")(DATA_PRESET=cfg["DATA_PRESET"], **node)


def _jax_slice(path_out, cache_dir):
    """Subprocess body: the JAX train loop of train_artiboost.py:342-367 on
    the cut config, with the pipelined mixed step (the default
    PIPELINE_SYNTH), every draw recorded. The state is initialised from a
    zero batch (not from the loader's first batch, which would consume
    draws the port's init does not make)."""
    import jax
    import jax.numpy as jnp

    from artiboost_tpu.artiboost.ccv import ovg_to_flat
    from artiboost_tpu.artiboost.loader import ArtiBoostLoader
    from artiboost_tpu.criterions import build_criterion
    from artiboost_tpu.datasets.hodata import HODataset
    from artiboost_tpu.metrics import build_evaluator
    from artiboost_tpu.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_tpu.models import build_arch
    from artiboost_tpu.parallel.train_state import (TrainState, build_optimizer,
                                                    make_mixed_train_step)

    cfg = slice_config(cache_dir)
    preset, bs = cfg["DATA_PRESET"], int(cfg["TRAIN"]["BATCH_SIZE"])
    seed = int(cfg["TRAIN"]["MANUAL_SEED"])
    real, out = real_dataset(HODataset, cfg), {}
    loader = ArtiBoostLoader(real_dataset=real, cfg=dict(cfg["MANAGER"], DATA_PRESET=preset),
                             batch_size=bs, n_epochs=1, seed=seed)
    vcfg, (O, V, G) = loader.view_cfg, loader.ccv.shape
    n_tex, n_bg = loader.assets.hand_color_bank.shape[0], loader.assets.backgrounds.shape[0]
    criterion, evaluator = build_criterion(cfg), build_evaluator(cfg["EVALUATOR"], preset)
    optimizer, _ = build_optimizer(cfg["TRAIN"])
    arch = build_arch(cfg["ARCH"], preset)
    S = preset["IMAGE_SIZE"][0]
    init_batch = {"image": jnp.zeros((1, S, S, 3)), "root_joint": jnp.zeros((1, 3)),
                  "cam_intr": jnp.eye(3)[None], "corners_can": jnp.zeros((1, 8, 3))}
    variables = jax.jit(lambda k, b: arch.init(k, b, train=True))(jax.random.PRNGKey(0),
                                                                 init_batch)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optimizer.init(variables["params"]))
    for k, v in jax.tree_util.tree_leaves_with_path({"params": state.params["model_list_0"],
                                                     "batch_stats": state.batch_stats["model_list_0"]}):
        out["model/" + "/".join(p.key for p in k)] = np.asarray(v)
    mixed_step = make_mixed_train_step(arch, criterion, optimizer)
    rec = {"triplets": [], "poses": [], "synth": [], "loss": [], "perm": []}

    def pose_draws(key, n):
        k_view, k_scram = jax.random.split(key)
        k1, k2, k3 = jax.random.split(k_view, 3)
        ku, kt = jax.random.split(k1)
        s1, s2 = jax.random.split(k_scram)
        return {"view/u": jax.random.uniform(ku, (n,)), "view/theta": jax.random.uniform(kt, (n,)),
                "view/roll": jax.random.uniform(k2, (n,)),
                "view/z": jax.random.uniform(k3, (n,), minval=vcfg.camera_z_min,
                                             maxval=vcfg.camera_z_max),
                "scram/tsl": jax.random.normal(s1, (n, 3)),
                "scram/ang": jax.random.normal(s2, (n, 16))}

    def synth_draws(key, n):
        keys = jax.random.split(key, 8)
        k_light, k_bg, k_pos, _ = jax.random.split(keys[4], 4)
        kb, kc, ks = jax.random.split(keys[6], 3)
        u = lambda k: jax.random.uniform(k, (n, 1, 1, 1), minval=0.7, maxval=1.3)
        return {"cjit": jax.random.uniform(keys[0], (n, 2)), "sjit": jax.random.normal(keys[1], (n,)),
                "rot": jax.random.uniform(keys[2], (n,), minval=-0.2, maxval=0.2),
                "tex_id": jax.random.randint(keys[3], (n,), 0, n_tex),
                "render/light": jax.random.uniform(k_light, (n, 1), minval=1.0, maxval=5.0),
                "render/bg_pos": jax.random.randint(k_pos, (n,), 0, 16),
                "render/bg_id": jax.random.randint(k_bg, (n,), 0, n_bg),
                "sigma": jax.random.uniform(keys[5], (n,)),
                "jitter/b": u(kb), "jitter/c": u(kc), "jitter/s": u(ks)}

    @jax.jit
    def loss_draws(key):
        out = []
        for loss, k in zip(criterion.loss_list, jax.random.split(key, 3)):
            d = {}
            if type(loss).__name__ in ("HandOrdLoss", "SceneOrdLoss"):
                d = jax_ordinal_draws(jax, k, loss)
            out.append(d)
        return {f"{i}/{k}": v for i, d in enumerate(out) for k, v in d.items()}

    pose_draws = jax.jit(pose_draws, static_argnums=1)
    synth_draws = jax.jit(synth_draws, static_argnums=1)

    def recorded_prepare(val):
        _, sub = jax.random.split(loader.key)  # the loader's _next_key()
        _, k_gen = jax.random.split(sub)
        (loader.prepare_val if val else loader.prepare)()
        g = loader.generated_val if val else loader.generated
        rec["triplets"].append(ovg_to_flat(g.obj_id, g.persp_id, g.grasp_id, V, G))
        n = int(g.obj_id.shape[0])
        chunk = min(loader.opg_batch_size, n)
        for _ in range(-(-n // chunk)):
            k_gen, s = jax.random.split(k_gen)
            rec["poses"].append(pose_draws(s, chunk))

    def measures(split):
        for m in evaluator.metrics_list:
            if not isinstance(m, ValMetricMean3DEPE2):
                for k, v in m.get_measures().items():
                    out[f"{split}/{type(m).__name__}/{k}"] = np.asarray(v)

    key = jax.random.PRNGKey(seed)
    recorded_prepare(False)  # the startup prepare
    recorded_prepare(False)
    k = loader.key
    for _ in range(2):  # iter_parts' real and synth permutation seeds
        k, s = jax.random.split(k)
        rec["perm"].append(jax.random.randint(s, (), 0, 2**31 - 1))
    evaluator.reset_all()
    final = []
    for real_batch, sidx in loader.iter_parts():
        key, k_synth, k_loss = jax.random.split(key, 3)
        rec["synth"].append(synth_draws(k_synth, int(sidx.shape[0])))
        synth = loader._synth_batch_jit(k_synth, loader.generated, sidx)
        real_dev = {k: jnp.asarray(v) for k, v in real_batch.items()}
        state, preds, losses, batch = mixed_step(state, real_dev, synth, k_loss)
        rec["loss"].append(loss_draws(k_loss))
        evaluator.feed_all(preds, batch, losses)
        final.append(float(losses["final_loss"]))
    out["train_final_loss"] = np.asarray(final)
    measures("train")
    assert not loader.should_val(0)
    loader.step_eval(0, evaluator)
    vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
    avg, seen = vm.get_averaged_maps()
    out.update({"avg": np.asarray(avg), "seen": np.asarray(seen),
                "weights": np.asarray(loader.ccv.sample_weight_map),
                "occurrence": np.asarray(loader.ccv.occurrence_map)})
    for kind, items in rec.items():
        for i, item in enumerate(items):
            if isinstance(item, dict):
                out.update({f"{kind}/{i}/{k}": np.asarray(v) for k, v in item.items()})
            else:
                out[f"{kind}/{i}"] = np.asarray(item)
    np.savez(path_out, **out)


def _unflatten(ref, prefix):
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = tree
            *scopes, leaf = k[len(prefix):].split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = v
    return tree


class ReplayDraws:
    """The loader's DrawSource interface, replaying the recorded JAX draws."""

    def __init__(self, ref):
        self.ref = ref
        self.count = {k: 0 for k in ("triplets", "poses", "synth", "perm", "loss")}

    def _next(self, kind):
        self.count[kind] += 1
        return self.count[kind] - 1

    def _tree(self, prefix):
        def t(v):
            return torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)

        return {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict) else t(v))
                for k, v in _unflatten(self.ref, prefix).items()}

    def triplets(self, space, n, replace):
        flat = self.ref[f"triplets/{self._next('triplets')}"]
        assert flat.shape == (n,)
        return torch.from_numpy(flat.astype(np.int64))

    def poses(self, pose_generator, B):
        return self._tree(f"poses/{self._next('poses')}/")

    def synth(self, synth_fn, B):
        return self._tree(f"synth/{self._next('synth')}/")

    def perm_seed(self):
        return int(self.ref[f"perm/{self._next('perm')}"])

    def loss(self, criterion):
        tree = self._tree(f"loss/{self._next('loss')}/")
        return [tree.get(str(i), {}) for i in range(len(criterion.loss_list))]


@pytest.fixture(scope="module")
def jax_slice(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_slice_ref")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # XLA's own threads, one a core, as when the bounds were read: on one
    # thread LossesMetric departs by 8.81e-3 against its 1e-2
    env = subprocess_env(*NO_FMA, "--xla_cpu_multi_thread_eigen=true")
    res = subprocess.run([sys.executable, __file__, str(d / "ref.npz"), str(d / "jax_cache")],
                         env=env, capture_output=True, text=True, timeout=time_left(), cwd=repo)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}, d


@pytest.mark.limit(1080)
def test_train_slice_against_jax(jax_slice):
    """``run`` on the cut config with every draw of the JAX run replayed and
    the flax initialisation carried across. Exact: the replay counts, the
    seen mask and the occurrence map. The rest within bounds set from the
    figures measured here, each at most 3x its figure:
      * per-step final_loss: step 0 within 1e-3 relative (measured 3.4e-4),
        every step within 5e-3 (2.1e-3);
      * the train epoch's LossesMetric averages within 1e-2 relative
        (3.5e-3) and Mean3DEPE within 4.7e-4 relative (1.57e-4);
      * the per-triplet EPE map within 8 mm where seen (2.88 mm, on maps
        of ~130 mm) and sample_weight_map within 0.1 relative (0.036).
    Before any update the two runs differ only in their inputs: the synth
    half's images differ on a few shade steps and silhouette pixels (FK
    sums in another order, ROADMAP C), one bf16 step each under IMAGE_BF16,
    and the random-init network turns that into 3.4e-4 of the loss. Adam's
    first steps are about lr * sign(g), so parameters whose gradients are
    near zero then move by +-lr on such differences, and the
    per-sample predictions drift apart by a few mm after four steps; the
    per-triplet map holds single samples, and method_1 turns their EPE into
    the weights through 1 / (confidence + 0.5)."""
    from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_torch.train import run
    from artiboost_torch.utils.convert import hybrid_baseline_from_flax

    ref, d = jax_slice
    cfg = slice_config(d / "torch_cache")
    replay = ReplayDraws(ref)
    # the port at the torch threads of the 8-core host the bounds were read
    # on: at one thread Mean3DEPE departs by 1.34e-3 against its 4.7e-4
    n_threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        out = run(cfg, epochs=1, device="cpu", draws=replay,
                  model_state=hybrid_baseline_from_flax(_unflatten(ref, "model/")))
    finally:
        torch.set_num_threads(n_threads)
    assert replay.count == {"triplets": 2, "poses": 2, "synth": 4, "perm": 2, "loss": 4}
    hist = out["history"][0]
    assert hist["train"]["steps"] == 4 and "val" not in hist
    rel = np.abs(np.asarray(hist["train"]["final_loss"]) / ref["train_final_loss"] - 1)
    assert rel[0] <= 1e-3 and rel.max() <= 5e-3, rel
    for name, bound in (("LossesMetric", 1e-2), ("Mean3DEPE", 4.7e-4)):
        for k, v in hist["train"]["measures"][name].items():
            r = float(ref[f"train/{name}/{k}"])
            assert abs(v - r) <= bound * abs(r), (name, k, v, r)
    vm = next(m for m in out["evaluator"].metrics_list if isinstance(m, ValMetricMean3DEPE2))
    avg, seen = vm.get_averaged_maps()
    ccv = out["loader"].ccv
    np.testing.assert_array_equal(seen.numpy(), ref["seen"])
    assert int(seen.sum()) > 0
    np.testing.assert_array_equal(ccv.occurrence_map.numpy(), ref["occurrence"])
    np.testing.assert_allclose(avg.numpy()[ref["seen"]], ref["avg"][ref["seen"]], atol=8.0, rtol=0)
    np.testing.assert_allclose(ccv.sample_weight_map.numpy(), ref["weights"], rtol=0.1, atol=0)
    assert not np.all(ref["weights"] == 1.0)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_slice(sys.argv[1], sys.argv[2])
