"""The port's synthetic batch (``artiboost_torch.artiboost.synth_batch``)
against the JAX package's ``make_synth_batch_fn`` key by key, at
config/synthetic_smoke.yaml size (128 x 128 crop, 64 x 64 quad-rate
raster, render LOD 128, B = 4), from the same pose cache and with the
JAX draws injected.

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so XLA
rounds a*b+c twice like the port (see tests/test_torch_raster.py).
Tolerances: integer keys exact; float32 keys at atol 1e-5 in metres
and 1e-4 in pixels (keys in pixel units carry ~1e-6 of the 128-pixel
frame: the crop affine subtracts offsets of ~1e2); IMAGE with
IMAGE_BF16 at 8e-3 (one bf16 ulp at 1.0). IMAGE in float32: at least
99 % of values within 1e-5 and all within 2e-4. FK and shading sum in
another order, which moves a vertex shade by ~1e-7 and can flip its
16-bit quantization step (4/65535 = 6.1e-5, times <= 2.2 of colour
jitter gain)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

NO_FMA_ENV = {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_cpu_max_isa=AVX"}
OBJS = ["synthobj_0", "synthobj_1", "synthobj_2", "synthobj_3"]
B = 4
CFG = dict(image_size=128, raw_size=256, cx=128.0, cy=128.0)
PIXEL_KEYS = {"joints_2d", "corners_2d", "cam_intr"}


def _jax_reference(path_out):
    import jax
    import jax.numpy as jnp

    from artiboost_tpu.artiboost.grasp_library import synthetic_grasp_library
    from artiboost_tpu.artiboost.object_library import synthetic_object_library
    from artiboost_tpu.artiboost.pose_generator import make_pose_generator
    from artiboost_tpu.artiboost.refiner import make_null_refiner
    from artiboost_tpu.artiboost.renderer import default_render_assets
    from artiboost_tpu.artiboost.scrambler import build_scrambler
    from artiboost_tpu.artiboost.synth_batch import SynthConfig, make_synth_batch_fn
    from artiboost_tpu.artiboost.view_engine import ViewEngineConfig
    from artiboost_tpu.mano.model import synthetic_mano_model

    mano = synthetic_mano_model()
    lib = synthetic_object_library(OBJS)
    assets = default_render_assets(mano)
    gen_fn = make_pose_generator(mano, lib, synthetic_grasp_library(4, 16), ViewEngineConfig(6, 8),
                                 build_scrambler({"TYPE": "random"}), make_null_refiner(mano))
    rng = np.random.RandomState(2)
    oid, vid, gid = (jnp.asarray(rng.randint(0, n, B)) for n in (4, 48, 16))
    gen = gen_fn(jax.random.PRNGKey(3), oid, vid, gid)
    out = {f"gen/{k}": np.asarray(getattr(gen, k)) for k in gen._fields}

    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, 8)
    k_light, k_bg, k_pos, _ = jax.random.split(keys[4], 4)
    kb, kc, ks = jax.random.split(keys[6], 3)
    n_tex, n_bg = assets.hand_color_bank.shape[0], assets.backgrounds.shape[0]
    draws = {
        "cjit": jax.random.uniform(keys[0], (B, 2)),
        "sjit": jax.random.normal(keys[1], (B,)),
        "rot": jax.random.uniform(keys[2], (B,), minval=-0.2, maxval=0.2),
        "tex_id": jax.random.randint(keys[3], (B,), 0, n_tex),
        "render/light": jax.random.uniform(k_light, (B, 1), minval=1.0, maxval=5.0),
        "render/bg_pos": jax.random.randint(k_pos, (B,), 0, 16),
        "render/bg_id": jax.random.randint(k_bg, (B,), 0, n_bg),
        "sigma": jax.random.uniform(keys[5], (B,)),
        "jitter/b": jax.random.uniform(kb, (B, 1, 1, 1), minval=0.7, maxval=1.3),
        "jitter/c": jax.random.uniform(kc, (B, 1, 1, 1), minval=0.7, maxval=1.3),
        "jitter/s": jax.random.uniform(ks, (B, 1, 1, 1), minval=0.7, maxval=1.3),
    }
    out.update({f"draws/{k}": np.asarray(v) for k, v in draws.items()})
    idx = jnp.arange(B, dtype=jnp.int32)
    for bf16 in (False, True):
        fn = jax.jit(make_synth_batch_fn(mano, lib, assets, SynthConfig(**CFG, image_bf16=bf16)))
        res = fn(key, gen, idx)
        for k, v in res.items():
            out[f"bf16={int(bf16)}/{k}"] = np.asarray(v.astype(jnp.float32)
                                                     if v.dtype == jnp.bfloat16 else v)
    np.savez(path_out, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_ref") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **NO_FMA_ENV,
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _nest(ref, prefix):
    d = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = d
            *scopes, leaf = k[len(prefix):].split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
    return d


@pytest.mark.parametrize("bf16", [False, True])
def test_synth_batch_key_by_key(jax_ref, bf16):
    from artiboost_torch.artiboost.object_library import synthetic_object_library
    from artiboost_torch.artiboost.pose_generator import GeneratedPoses
    from artiboost_torch.artiboost.renderer import default_render_assets
    from artiboost_torch.artiboost.synth_batch import SynthBatch, SynthConfig
    from artiboost_torch.mano.model import synthetic_mano_model

    mano = synthetic_mano_model(device="cpu")
    fn = SynthBatch(mano, synthetic_object_library(OBJS, device="cpu"),
                    default_render_assets(mano, device="cpu"),
                    SynthConfig(**CFG, image_bf16=bf16), device="cpu")
    gen = GeneratedPoses(**_nest(jax_ref, "gen/"))
    out = fn(gen, torch.arange(B), _nest(jax_ref, "draws/"))
    prefix = f"bf16={int(bf16)}/"
    keys = {k[len(prefix):] for k in jax_ref if k.startswith(prefix)}
    assert keys == set(out)
    for k in sorted(keys):
        ref = jax_ref[prefix + k]
        got = out[k].float().numpy() if out[k].is_floating_point() else out[k].numpy()
        assert got.shape == ref.shape, (k, got.shape, ref.shape)
        if ref.dtype.kind in "iu":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        elif k == "image":
            err = np.abs(got - ref)
            assert (ref > -0.5).mean() > 0.5  # not a blank frame
            if bf16:
                assert err.max() <= 8e-3, err.max()
            else:
                assert err.max() <= 2e-4 and (err <= 1e-5).mean() >= 0.99, (
                    err.max(), (err > 1e-5).mean())
        else:
            atol = 1e-4 if k in PIXEL_KEYS else 1e-5
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=k)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_reference(sys.argv[1])
