"""The main-path gate (ROADMAP North star): ``artiboost_torch.train.run`` on
the uncut config/synthetic_smoke.yaml against the JAX package's train loop
(``train/train_artiboost.py:342-378``, the pipelined mixed step), on the
CPU. Two epochs of 8 mixed steps (8 SyntheticHO + 8 synth per batch of
16), each followed by the val sweep (VAL_LEN 32, two batches), the
``method_1`` reweight from it and the TEST pass over the 32-sample test
split (``--test_freq 1``).

Every random draw of the JAX run (triplet ids, pose draws, the epochs'
permutation seeds, synth draws per batch, criterion draws per train, val
and test batch) is recorded and replayed into the port, and the model
starts from the JAX initialisation, as in tests/test_torch_train_slice.py.
Both sides read the same SyntheticHO images: the JAX side wraps the
port's, which ``run`` rebuilds bit for bit from the same seed
(SyntheticHO itself is held in tests/test_torch_data.py). The JAX side
runs in a subprocess with ``--xla_cpu_max_isa=AVX`` (separately rounded
a*b+c, see tests/test_torch_raster.py). Bounds are in the test's
docstring."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._proc import NO_FMA, subprocess_env, time_left
from tests.test_torch_train import jax_ordinal_draws
from tests.test_torch_train_slice import ReplayDraws, _unflatten

CFG_PATH = "config/synthetic_smoke.yaml"
EPOCHS = 2


def gate_config(cache_dir, cfg_path=CFG_PATH, train_cfg=None):
    """The config as it stands; only the blacklist cache moves to the
    test's directory, and ``train_cfg`` (a dict) overrides TRAIN's keys."""
    from artiboost_torch.utils.config import load_config

    cfg = load_config(cfg_path)
    cfg["MANAGER"]["CACHE_DIR"] = str(cache_dir)
    cfg["TRAIN"].update(train_cfg or {})
    return cfg


def split_dataset(base, cfg, split):
    """DATASET.<split> on the JAX side: the JAX package's HODataset pipeline
    over the images and annotations of the port's SyntheticHO."""
    from artiboost_torch.datasets.synthetic import build_dataset
    from tests.test_torch_data import _accessors

    node = cfg["DATASET"][split]
    ds = build_dataset(node, cfg["DATA_PRESET"], device="cpu")
    fx = {"images": ds.images.numpy(), "intr": ds._intr, "raw": ds.raw_size[0],
          "joints": ds._joints, "corners_can": ds._corners_can, "obj_pose": ds._obj_pose,
          "obj_verts_can": ds._obj_verts_can, "hand_verts": ds._hand_verts,
          "hand_pose": ds._hand_pose, "hand_shape": ds._hand_shape, "obj_id": ds._obj_id}
    return _accessors(base, fx, "right")(DATA_PRESET=cfg["DATA_PRESET"],
                                         **{k: v for k, v in node.items() if k != "TYPE"})


def _jax_gate(path_out, cache_dir, cfg_path=CFG_PATH, epochs=EPOCHS, train_cfg=None,
              synth_batches=False, val=True):
    """Subprocess body: the loop of train_artiboost.py:342-378 on the
    config, every draw recorded, with the measures of every pass and the
    mining state after every epoch; with ``synth_batches`` also every
    synth batch, train and val, in the order they were made. The state is initialised from a zero
    batch, as in tests/test_torch_train_slice.py. With ``val`` False the
    config's val gate must be closed: no val sweep, and the mining reads the
    train pass's evaluator, as ``run`` does then."""
    import jax
    import jax.numpy as jnp

    from artiboost_tpu.artiboost.ccv import ovg_to_flat
    from artiboost_tpu.artiboost.loader import ArtiBoostLoader
    from artiboost_tpu.criterions import build_criterion
    from artiboost_tpu.datasets.hodata import HODataset, padded_host_loader
    from artiboost_tpu.metrics import build_evaluator
    from artiboost_tpu.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_tpu.models import build_arch
    from artiboost_tpu.parallel.train_state import (TrainState, build_optimizer,
                                                    make_eval_step, make_mixed_train_step)
    from train.train_artiboost import _ensure_synth_ids, _to_device_batch

    cfg = gate_config(cache_dir, cfg_path, train_cfg)
    preset, bs = cfg["DATA_PRESET"], int(cfg["TRAIN"]["BATCH_SIZE"])
    seed = int(cfg["TRAIN"]["MANUAL_SEED"])
    real, test = split_dataset(HODataset, cfg, "TRAIN"), split_dataset(HODataset, cfg, "TEST")
    loader = ArtiBoostLoader(real_dataset=real, cfg=dict(cfg["MANAGER"], DATA_PRESET=preset),
                             batch_size=bs, n_epochs=epochs, seed=seed)
    vcfg, (O, V, G) = loader.view_cfg, loader.ccv.shape
    n_tex, n_bg = loader.assets.hand_color_bank.shape[0], loader.assets.backgrounds.shape[0]
    criterion = build_criterion(cfg)
    evaluator = build_evaluator(cfg["EVALUATOR"], preset)
    test_evaluator = build_evaluator([m for m in cfg["EVALUATOR"]
                                      if not m["TYPE"].startswith("ValMetric")], preset)
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
    out = {}
    for k, v in jax.tree_util.tree_leaves_with_path({"params": state.params["model_list_0"],
                                                     "batch_stats": state.batch_stats["model_list_0"]}):
        out["model/" + "/".join(p.key for p in k)] = np.asarray(v)
    mixed_step = make_mixed_train_step(arch, criterion, optimizer)
    eval_step = make_eval_step(arch, criterion)
    rec = {"triplets": [], "poses": [], "synth": [], "loss": [], "perm": []}
    if synth_batches:
        rec["synth_batch"] = []

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
        u = lambda k: jax.random.uniform(k, (n, 1, 1, 1), minval=0.7, maxval=1.3)  # noqa: E731
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
        for loss, k in zip(criterion.loss_list, jax.random.split(key, len(criterion.loss_list))):
            d = {}
            if type(loss).__name__ in ("HandOrdLoss", "SceneOrdLoss"):
                d = jax_ordinal_draws(jax, k, loss)
            out.append(d)
        return {f"{i}/{k}": v for i, d in enumerate(out) for k, v in d.items()}

    def host_batch(batch):
        """On the host, bf16 as float32 (npz keeps no bf16; the cast back is exact)."""
        return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
                for k, v in batch.items()}

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

    def measures(ev, prefix):
        for name, scalars in ev.get_measures_all_striped().items():
            for k, v in scalars.items():
                out[f"{prefix}/{name}/{k}"] = np.asarray(v)

    def evaluate(batches, ev, key):
        ev.reset_all()
        for batch in batches:
            key, k_loss = jax.random.split(key)
            preds, losses = eval_step(state, batch, k_loss)
            rec["loss"].append(loss_draws(k_loss))
            ev.feed_all(preds, batch, losses)
        return key

    def val_batches():
        it = loader.iter_val()
        while True:
            _, sub = jax.random.split(loader.key)  # the synth key iter_val takes next
            batch = next(it, None)
            if batch is None:
                return
            rec["synth"].append(synth_draws(sub, bs))
            if synth_batches:
                rec["synth_batch"].append(host_batch(batch))
            yield batch

    key = jax.random.PRNGKey(seed)
    recorded_prepare(False)  # the startup prepare
    for epoch in range(epochs):
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
            if synth_batches:  # copied now: the mixed step donates its inputs
                rec["synth_batch"].append(host_batch(synth))
            real_dev = {k: jnp.asarray(v) for k, v in real_batch.items()}
            state, preds, losses, batch = mixed_step(state, real_dev, synth, k_loss)
            rec["loss"].append(loss_draws(k_loss))
            evaluator.feed_all(preds, batch, losses)
            final.append(float(losses["final_loss"]))
        out[f"{epoch}/train_final_loss"] = np.asarray(final)
        measures(evaluator, f"{epoch}/train")
        assert loader.should_val(epoch) == val
        if val:
            recorded_prepare(True)
            key = evaluate(val_batches(), evaluator, key)
            measures(evaluator, f"{epoch}/val")
        loader.step_eval(epoch, evaluator)
        vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
        avg, seen = vm.get_averaged_maps()
        out.update({f"{epoch}/avg": np.asarray(avg), f"{epoch}/seen": np.asarray(seen),
                    f"{epoch}/weights": np.asarray(loader.ccv.sample_weight_map),
                    f"{epoch}/occurrence": np.asarray(loader.ccv.occurrence_map)})
        test_batches = (_ensure_synth_ids(_to_device_batch(b))
                        for b in padded_host_loader(test, bs))
        key = evaluate(test_batches, test_evaluator, key)
        measures(test_evaluator, f"{epoch}/test")
    for kind, items in rec.items():
        for i, item in enumerate(items):
            if isinstance(item, dict):
                out.update({f"{kind}/{i}/{k}": np.asarray(v) for k, v in item.items()})
            else:
                out[f"{kind}/{i}"] = np.asarray(item)
    np.savez(path_out, **out)


def run_jax_gate(tmp_path_factory, script, *args):
    """``script`` (a gate test file, whose main runs ``_jax_gate`` on its
    config) in a subprocess, ``args`` after its two paths, killed before the
    test's time limit -> (the recorded JAX run, its directory)."""
    d = tmp_path_factory.mktemp("gate_ref")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = subprocess_env(*NO_FMA)
    res = subprocess.run([sys.executable, script, str(d / "ref.npz"), str(d / "jax_cache"), *args],
                         env=env, capture_output=True, text=True, timeout=time_left(), cwd=repo)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}, d


@pytest.fixture(scope="module")
def jax_gate(tmp_path_factory):
    return run_jax_gate(tmp_path_factory, __file__)


class ReplaySynthBatches:
    """The port's synth batch function with every batch it makes replaced,
    key by key, by the one the JAX run recorded in the same place, so the
    two runs differ in no input. ``count`` says how many it replaced."""

    def __init__(self, fn, ref):
        self.fn, self.ref, self.count = fn, ref, 0

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args):
        batch = self.fn(*args)
        prefix = f"synth_batch/{self.count}/"
        self.count += 1
        assert {k[len(prefix):] for k in self.ref if k.startswith(prefix)} == set(batch)
        for k, v in batch.items():
            want = self.ref[prefix + k]
            assert want.shape == tuple(v.shape), (k, want.shape, v.shape)
            batch[k] = torch.from_numpy(want).to(v.dtype)
        return batch


def run_torch_gate(jax_gate, cfg_path=CFG_PATH, epochs=EPOCHS, train_cfg=None,
                   synth_batches=False, threads=1):
    """``run`` on the config with the JAX draws replayed from the flax
    initialisation, at ``threads`` torch threads; the mining state is copied after
    every epoch's step_eval. With ``synth_batches`` every synth batch is
    the JAX run's (``ReplaySynthBatches``, kept as ``replay.synth_batches``).
    -> (ref, run's result, states, replay)."""
    from artiboost_torch import train
    from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_torch.utils.convert import FROM_FLAX

    ref, d = jax_gate
    cfg = gate_config(d / "torch_cache", cfg_path, train_cfg)
    after = []

    replay = ReplayDraws(ref)

    class Loader(train.ArtiBoostLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if synth_batches:
                self.synth_batch_fn = replay.synth_batches = ReplaySynthBatches(
                    self.synth_batch_fn, ref)

        def step_eval(self, epoch_idx, evaluator):
            super().step_eval(epoch_idx, evaluator)
            vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
            avg, seen = vm.get_averaged_maps()
            after.append({"avg": avg.clone(), "seen": seen.clone(),
                          "weights": self.ccv.sample_weight_map.clone(),
                          "occurrence": self.ccv.occurrence_map.clone()})

    n_threads, orig = torch.get_num_threads(), train.ArtiBoostLoader
    torch.set_num_threads(threads)
    train.ArtiBoostLoader = Loader
    try:
        out = train.run(cfg, epochs=epochs, device="cpu", draws=replay,
                        model_state=FROM_FLAX[cfg["ARCH"]["TYPE"]](_unflatten(ref, "model/")),
                        test_freq=1)
    finally:
        train.ArtiBoostLoader = orig
        torch.set_num_threads(n_threads)
    return ref, out, after, replay


@pytest.fixture(scope="module")
def torch_gate(jax_gate):
    return run_torch_gate(jax_gate)


def _bound(name, key):
    """The relative bound of one measure (see test_gate_against_jax)."""
    if name == "LossesMetric":
        return 0.18 if "ord" in key else 2.5e-2
    return 1.2e-2 if name == "ValMetricMean3DEPE2" else 2.2e-2


@pytest.mark.limit(1020)
def test_gate_against_jax(torch_gate):
    """The uncut smoke config, two epochs, against the JAX loop. Exact: the
    replay counts, every pass's batch count, and after each epoch the seen
    mask and the occurrence map. Bounds, each at most 3x the largest figure
    measured here over both epochs and all three passes (in parentheses):
      * per-step train final_loss within 6e-2 relative (2.03e-2, the last
        step of epoch 1; 4.7e-3 in epoch 0);
      * LossesMetric: the ordinal terms (joint_ord_loss, part_ord_loss,
        hand_ord_loss_output, scene_ord_loss*) within 0.18 relative (6.11e-2,
        part_ord_loss at ~1e-5, whose hinge counts flip on a sample), the
        other terms within 2.5e-2 (8.5e-3);
      * Mean3DEPE within 2.2e-2 relative (7.4e-3) and ValMetricMean3DEPE2's
        val_epe_mean within 1.2e-2 (4.0e-3);
      * the per-triplet EPE map within 20 mm where seen (6.66 mm after epoch
        1, 2.72 after epoch 0, on maps of ~145 mm), and sample_weight_map
        within 0.45 relative (0.163 after epoch 1, 0.026 after epoch 0).
    Before any update the two runs differ only in their synth images (FK
    sums in another order, ROADMAP C); Adam's first steps move parameters
    with near-zero gradients by +-lr on such differences, so the
    predictions drift apart over the 16 steps, as in
    tests/test_torch_train_slice.py (whose 4 steps this extends); the
    second epoch's weights compound two reweights, each turning
    single-sample EPEs into weights through 1 / (confidence + 0.5)."""
    ref, out, after, replay = torch_gate
    assert replay.count == {"triplets": 1 + 2 * EPOCHS, "poses": 1 + 2 * EPOCHS,
                            "synth": EPOCHS * (8 + 2), "perm": 2 * EPOCHS,
                            "loss": EPOCHS * (8 + 2 + 2)}
    for epoch, hist in enumerate(out["history"]):
        assert hist["epoch"] == epoch and hist["train"]["steps"] == 8
        assert hist["val"]["batches"] == 2 and hist["test"]["batches"] == 2
        rel = np.abs(np.asarray(hist["train"]["final_loss"]) / ref[f"{epoch}/train_final_loss"] - 1)
        assert rel.max() <= 6e-2, (epoch, rel)
        for split in ("train", "val", "test"):
            measures = hist[split]["measures"]
            want = {k.split("/")[2] for k in ref if k.startswith(f"{epoch}/{split}/")}
            assert set(measures) == want == ({"LossesMetric", "Mean3DEPE"} | (
                set() if split == "test" else {"ValMetricMean3DEPE2"}))
            for name, scalars in measures.items():
                assert len(scalars) == sum(k.startswith(f"{epoch}/{split}/{name}/") for k in ref)
                for k, v in scalars.items():
                    r = float(ref[f"{epoch}/{split}/{name}/{k}"])
                    assert abs(v - r) <= _bound(name, k) * abs(r), (epoch, split, name, k, v, r)
        state = after[epoch]
        seen = ref[f"{epoch}/seen"]
        np.testing.assert_array_equal(state["seen"].numpy(), seen)
        assert int(seen.sum()) == 32
        np.testing.assert_array_equal(state["occurrence"].numpy(), ref[f"{epoch}/occurrence"])
        np.testing.assert_allclose(state["avg"].numpy()[seen], ref[f"{epoch}/avg"][seen],
                                   atol=20.0, rtol=0)
        np.testing.assert_allclose(state["weights"].numpy(), ref[f"{epoch}/weights"], rtol=0.45,
                                   atol=0)
        assert not np.all(ref[f"{epoch}/weights"] == 1.0)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_gate(sys.argv[1], sys.argv[2])
