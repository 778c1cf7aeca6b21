"""Slice 1 end to end: two epochs of the synthesis-and-mining loop of the
port (the val half of ``artiboost_torch.train.run``'s epoch: startup
prepare, then per epoch prepare, prepare_val, ``train.val_epoch`` with the
HybridBaseline forward and ValMetricMean3DEPE2, step_eval with method_1;
the train half is held in tests/test_torch_train_slice.py) against the
same loop driven through the JAX package's ArtiBoostLoader, at
config/synthetic_smoke.yaml size (CCV 4 x 48 x 16, batch 16, VAL_LEN 32,
128 x 128 crop, ResNet18), on the CPU.

Every random draw of the JAX run (triplet ids, view and scrambler noise
per pose chunk, synth draws per batch) is recorded and replayed into the
port; the model starts from the JAX initialisation carried across by
``hybrid_baseline_from_flax``. The JAX side runs in a subprocess with
``--xla_cpu_max_isa=AVX`` (separately rounded a*b+c, see
tests/test_torch_raster.py).

Tolerances: the seen mask and the occurrence map exact; the per-triplet
EPE map within atol 5e-2 mm; sample_weight_map within rtol 1e-3. From
the same inputs the forward agrees to 2e-3 mm (tests/test_torch_model.py);
the images do not quite agree: FK and shading sum in another order and
flip 16-bit shade steps on ~0.4 % of values (tests/test_torch_synth.py),
and the random-init network moves its joints by up to 0.03 mm in
response (the largest difference measured here, with bf16 and with
float32 images alike). method_1 multiplies a weight by
1 / (confidence + 0.5) with confidence = (max - EPE) / range, so 5e-2 mm
over the ~80 mm EPE range of a random-init model moves it by at most
1.3e-3 relative per epoch (measured: 3.3e-4 after two epochs, seed 1 of
the config's TRAIN.MANUAL_SEED). Bit-equal images are out of reach: XLA's
sin and cos round differently from torch's in the last bit, so even the
joint rotations of aa_to_rotmat differ (ROADMAP C)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._proc import NO_FMA, subprocess_env

CFG_PATH = "config/synthetic_smoke.yaml"


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_reference(path_out, cache_dir):
    import jax

    from artiboost_tpu.artiboost.ccv import ovg_to_flat
    from artiboost_tpu.artiboost.loader import ArtiBoostLoader
    from artiboost_tpu.metrics.evaluator import Evaluator
    from artiboost_tpu.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_tpu.models import build_arch
    from artiboost_tpu.utils.config import load_config

    cfg = load_config(CFG_PATH)
    manager = dict(cfg["MANAGER"], DATA_PRESET=cfg["DATA_PRESET"], CACHE_DIR=cache_dir)
    bs = int(cfg["TRAIN"]["BATCH_SIZE"])
    loader = ArtiBoostLoader(cfg=manager, batch_size=bs, n_epochs=2,
                             seed=int(cfg["TRAIN"]["MANUAL_SEED"]))
    vcfg = loader.view_cfg
    O, V, G = loader.ccv.shape
    metric_cfg = [m for m in cfg["EVALUATOR"] if m["TYPE"] == "ValMetricMean3DEPE2"][0]
    evaluator = Evaluator([ValMetricMean3DEPE2(**{k: v for k, v in metric_cfg.items()
                                                  if k != "TYPE"})])
    arch = build_arch(cfg["ARCH"], cfg["DATA_PRESET"])
    out = {}
    rec = {"triplets": [], "poses": [], "synth": []}
    n_tex = loader.assets.hand_color_bank.shape[0]
    n_bg = loader.assets.backgrounds.shape[0]

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
        return {"cjit": jax.random.uniform(keys[0], (n, 2)),
                "sjit": jax.random.normal(keys[1], (n,)),
                "rot": jax.random.uniform(keys[2], (n,), minval=-0.2, maxval=0.2),
                "tex_id": jax.random.randint(keys[3], (n,), 0, n_tex),
                "render/light": jax.random.uniform(k_light, (n, 1), minval=1.0, maxval=5.0),
                "render/bg_pos": jax.random.randint(k_pos, (n,), 0, 16),
                "render/bg_id": jax.random.randint(k_bg, (n,), 0, n_bg),
                "sigma": jax.random.uniform(keys[5], (n,)),
                "jitter/b": u(kb), "jitter/c": u(kc), "jitter/s": u(ks)}

    def recorded_prepare(val: bool):
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

    variables = None
    apply = jax.jit(lambda v, b: arch.apply(v, b, train=False))
    recorded_prepare(False)  # startup prepare (the reference runs it twice)
    for epoch in range(2):
        recorded_prepare(False)
        assert loader.should_val(epoch)
        recorded_prepare(True)
        evaluator.reset_all()
        it = loader.iter_val()
        while True:
            _, sub = jax.random.split(loader.key)
            batch = next(it, None)
            if batch is None:
                break
            rec["synth"].append(synth_draws(sub, bs))
            if variables is None:
                variables = arch.init(jax.random.PRNGKey(0), batch, train=False)
            evaluator.feed_all(apply(variables, batch), batch, {})
        loader.step_eval(epoch, evaluator)
    avg, seen = evaluator.metrics_list[0].get_averaged_maps()
    out.update({"avg": np.asarray(avg), "seen": np.asarray(seen),
                "weights": np.asarray(loader.ccv.sample_weight_map),
                "occurrence": np.asarray(loader.ccv.occurrence_map)})
    for kind, items in rec.items():
        for i, item in enumerate(items):
            if isinstance(item, dict):
                out.update({f"{kind}/{i}/{k}": np.asarray(v) for k, v in item.items()})
            else:
                out[f"{kind}/{i}"] = np.asarray(item)
    hb = {"params": variables["params"]["model_list_0"],
          "batch_stats": variables["batch_stats"]["model_list_0"]}
    _flatten(hb, "model/", out)
    np.savez(path_out, **out)


class ReplayDraws:
    """The loader's DrawSource interface, replaying recorded JAX draws."""

    def __init__(self, ref):
        self.ref = ref
        self.count = {"triplets": 0, "poses": 0, "synth": 0}
        # the val losses' draws: the ordinal losses do not feed the EPE maps
        self.generator = torch.Generator().manual_seed(0)

    def _next(self, kind):
        i = self.count[kind]
        self.count[kind] += 1
        return i

    def _tree(self, prefix):
        to_t = lambda v: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
        tree = _unflatten(self.ref, prefix)
        return {k: ({kk: to_t(vv) for kk, vv in v.items()} if isinstance(v, dict) else to_t(v))
                for k, v in tree.items()}

    def triplets(self, space, n, replace):
        flat = self.ref[f"triplets/{self._next('triplets')}"]
        assert flat.shape == (n,)
        return torch.from_numpy(flat.astype(np.int64))

    def poses(self, pose_generator, B):
        return self._tree(f"poses/{self._next('poses')}/")

    def synth(self, synth_fn, B):
        return self._tree(f"synth/{self._next('synth')}/")

    def loss(self, criterion):
        return criterion.draws(self.generator, "cpu")


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


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice_ref")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = subprocess_env(*NO_FMA)
    res = subprocess.run([sys.executable, __file__, str(d / "ref.npz"), str(d / "jax_cache")],
                         env=env, capture_output=True, text=True, timeout=240, cwd=repo)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}, d


@pytest.mark.limit(330)
def test_val_and_mining_epochs(jax_ref):
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.train import StageTimer, val_epoch
    from artiboost_torch.train import slice_config as loader_cfg
    from artiboost_torch.utils.config import load_config
    from artiboost_torch.utils.convert import hybrid_baseline_from_flax

    ref, d = jax_ref
    cfg = load_config(CFG_PATH)
    cfg["MANAGER"]["CACHE_DIR"] = str(d / "torch_cache")
    replay = ReplayDraws(ref)
    loader = ArtiBoostLoader(cfg=loader_cfg(cfg), batch_size=16, n_epochs=2,
                             seed=int(cfg["TRAIN"]["MANUAL_SEED"]), device="cpu", draws=replay)
    arch = build_arch(cfg["ARCH"], cfg["DATA_PRESET"])
    arch.model_list[0].load_state_dict(hybrid_baseline_from_flax(_unflatten(ref, "model/")))
    criterion = build_criterion(cfg)
    evaluator = build_evaluator(cfg["EVALUATOR"], device="cpu")
    timer = StageTimer(torch.device("cpu"))
    loader.prepare()  # startup prepare (the reference runs it twice)
    n_val_batches = 0
    for epoch in range(2):
        loader.prepare()
        assert loader.should_val(epoch)
        loader.prepare_val()
        n_val_batches += val_epoch(loader, arch, criterion, evaluator, timer)["batches"]
        loader.step_eval(epoch, evaluator)
    assert replay.count == {"triplets": 5, "poses": 5, "synth": 4}
    assert n_val_batches == 4
    ccv = loader.ccv
    vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
    avg, seen = vm.get_averaged_maps()
    np.testing.assert_array_equal(seen.numpy(), ref["seen"])
    assert int(seen.sum()) == 32
    np.testing.assert_array_equal(ccv.occurrence_map.numpy(), ref["occurrence"])
    np.testing.assert_allclose(avg.numpy()[ref["seen"]], ref["avg"][ref["seen"]], atol=5e-2, rtol=0)
    np.testing.assert_allclose(ccv.sample_weight_map.numpy(), ref["weights"], rtol=1e-3, atol=0)
    assert not np.all(ref["weights"] == 1.0)

    # the checkpoint state round-trips through a fresh loader
    state = loader.state_dict()
    fresh = type(loader)(cfg=loader_cfg(cfg), batch_size=16, device="cpu")
    fresh.load_state_dict(state)
    np.testing.assert_array_equal(fresh.ccv.sample_weight_map.numpy(), state["sample_weight_map"])
    np.testing.assert_array_equal(fresh.ccv.occurrence_map.numpy(), state["occurrence_map"])
    assert torch.equal(fresh.generator.get_state(), loader.generator.get_state())
    assert fresh.epoch_idx == 1


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_reference(sys.argv[1], sys.argv[2])
