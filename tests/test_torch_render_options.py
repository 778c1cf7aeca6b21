"""The renderer options of the synthetic batch against the JAX package: the
horizontal motion blur (``renderer.motion_blur_h`` against
``_motion_blur_h``, and its per-sample choice), the bilinear texel gather
(``sample_textures(bilinear=True)``), and the untextured Gouraud route of
``SynthBatch`` (``SynthConfig(textured=False)``, the fixture of JAX's
``tests/test_uv_raster.py:280-320``: 128 x 128 crop, no augmentation, B =
2) with a motion blur of width 7 that the JAX draws give one sample and
not the other, key by key from the same poses and with the JAX draws
injected; then the loader built with each option.

The JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so XLA
rounds a*b+c twice like the port (see tests/test_torch_raster.py).
Tolerances: the blur within 1e-6 (the same k - 1 float adds in the same
order, then one multiply); the bilinear gather within 1e-5 (the texel
weights come from the same float ops, the two-hot sum adds two products);
the synthetic batch at ``tests/test_torch_synth.py``'s bounds: integer
keys exact, float32 keys within 1e-5 (1e-4 in pixels), IMAGE at least
99 % within 1e-5 and all within 2e-4 (FK's sin/cos and the Lambert sum
move a vertex colour by ~1e-7, which can flip the Gouraud raster's 8-bit
step of 1/255 at a pixel, and the motion blur spreads such a step over its
width / 7)."""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._proc import NO_FMA, subprocess_env

B = 2
BASE = dict(image_size=128, fx=200.0, fy=200.0, cx=64.0, cy=64.0, aug=False)
FLAT_BLUR = dict(textured=False, motion_blur=7, motion_blur_prob=0.2)
PIXEL_KEYS = {"joints_2d", "corners_2d", "cam_intr"}


def _blur_and_gather_inputs():
    rng = np.random.RandomState(0)
    img = rng.rand(3, 9, 20, 3).astype(np.float32)
    P, T = 3, 300  # three windows of 127 lanes a texel row
    atlas = rng.rand(P, T, T, 3).astype(np.float32)
    u12, v12 = rng.randint(0, 4096, (2, 4, 8, 8))
    quv = (u12 * 4096 + v12).astype(np.float32)
    quv[0, 0, :4] = [0.0, 4095.0, 4095.0 * 4096, 4095.0 * 4096 + 4095]  # the atlas' corners
    shade = (rng.rand(4, 8, 8) * 2).astype(np.float32)
    page = rng.randint(0, P, (4, 8, 8)).astype(np.int32)
    return img, atlas, quv, shade, page


def _jax_reference(path_out):
    import jax
    import jax.numpy as jnp

    from artiboost_tpu.artiboost.grasp_library import synthetic_grasp_library
    from artiboost_tpu.artiboost.object_library import synthetic_object_library
    from artiboost_tpu.artiboost.pose_generator import make_pose_generator
    from artiboost_tpu.artiboost.refiner import build_refiner
    from artiboost_tpu.artiboost.renderer import (SceneTextures, _motion_blur_h,
                                                  default_render_assets, sample_textures)
    from artiboost_tpu.artiboost.scrambler import build_scrambler
    from artiboost_tpu.artiboost.synth_batch import SynthConfig, make_synth_batch_fn
    from artiboost_tpu.artiboost.view_engine import ViewEngineConfig
    from artiboost_tpu.mano.model import get_mano_model

    out = {}
    img, atlas, quv, shade, page = _blur_and_gather_inputs()
    for k in (7, 4):
        out[f"blur/{k}"] = np.asarray(jax.jit(_motion_blur_h, static_argnums=1)(img, k))
    # op by op, as written: jitted, XLA's fusion moved 12 of these 768
    # values by up to 3.2e-5 (measured), beyond the bound held here
    tex = SceneTextures(atlas=jnp.asarray(atlas), hand_page=None, obj_page=None, uv=None,
                        n_hand_faces=0)
    for s in (1, 2):
        out[f"bilinear/{s}"] = np.asarray(sample_textures(
            jnp.asarray(quv), jnp.asarray(shade), jnp.asarray(page), tex, bilinear=True,
            subsample=s))

    mano = get_mano_model()
    obj_lib = synthetic_object_library(["a", "b"])
    assets = default_render_assets(mano)
    gen_fn = make_pose_generator(
        mano, obj_lib, synthetic_grasp_library(2, 5), ViewEngineConfig(4, 6),
        build_scrambler({"TYPE": "naive", "HAND_TSL_SIGMA": 0.0, "HAND_POSE_SIGMA": 0.0}),
        build_refiner({"TYPE": "null"}, mano))
    rng = np.random.RandomState(0)
    gen = jax.jit(gen_fn)(jax.random.PRNGKey(0), jnp.asarray(rng.randint(0, 2, B)),
                 jnp.asarray(rng.randint(0, 24, B)), jnp.asarray(rng.randint(0, 5, B)))
    out.update({f"gen/{k}": np.asarray(getattr(gen, k)) for k in gen._fields})
    key = jax.random.PRNGKey(1)
    keys = jax.random.split(key, 8)
    k_light, k_bg, k_pos, k_mb = jax.random.split(keys[4], 4)
    n_tex, n_bg = assets.hand_color_bank.shape[0], assets.backgrounds.shape[0]
    draws = {"tex_id": jax.random.randint(keys[3], (B,), 0, n_tex),
             "render/light": jax.random.uniform(k_light, (B, 1), minval=1.0, maxval=5.0),
             "render/bg_pos": jax.random.randint(k_pos, (B,), 0, 16),
             "render/bg_id": jax.random.randint(k_bg, (B,), 0, n_bg),
             "render/mb": jax.random.uniform(k_mb, (B,))}
    out.update({f"draws/{k}": np.asarray(v) for k, v in draws.items()})
    fn = jax.jit(make_synth_batch_fn(mano, obj_lib, assets, SynthConfig(**BASE, **FLAT_BLUR)))
    for k, v in fn(key, gen, jnp.arange(B)).items():
        out[f"batch/{k}"] = np.asarray(v)
    np.savez(path_out, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("options_ref") / "ref.npz"
    # XLA's own threads, one a core, as when the bounds were read: on one
    # thread a vertex moves by 6e-8 and an untextured pixel rounds a 1/255
    # step the other way (3.9e-3 against test_untextured_synth_batch's 2e-4)
    env = subprocess_env(*NO_FMA, "--xla_cpu_multi_thread_eigen=true")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                         text=True, timeout=240)
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


@pytest.mark.parametrize("k", [7, 4])
def test_motion_blur_h(jax_ref, k):
    from artiboost_torch.artiboost.renderer import motion_blur_h

    img = _blur_and_gather_inputs()[0]
    got = motion_blur_h(torch.from_numpy(img), k).numpy()
    np.testing.assert_allclose(got, jax_ref[f"blur/{k}"], atol=1e-6, rtol=0)


def test_motion_blur_per_sample_choice():
    """``render_scene`` blurs exactly the samples whose ``mb`` draw is below
    MOTION_BLUR_PROB, before the background composite."""
    from artiboost_torch.artiboost.renderer import motion_blur_h, render_draws, render_scene

    B_, H = 4, 24
    rng = np.random.RandomState(4)
    verts = torch.from_numpy(np.array([[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5],
                                       [0.0, 0.05, 0.5]], np.float32))[None].repeat(B_, 1, 1)
    colors = torch.from_numpy(rng.rand(B_, 3, 3).astype(np.float32))
    faces = torch.tensor([[0, 1, 2]]).expand(B_, 1, 3)
    intr = torch.tensor([[100.0, 0, 12.0], [0, 100.0, 12.0], [0, 0, 1]]).expand(B_, 3, 3)
    bgs = torch.from_numpy(rng.rand(2, 36, 36, 3).astype(np.float32))
    draws = render_draws(torch.Generator().manual_seed(0), B_, 2, 16, "cpu", motion_blur=True)
    draws["mb"] = torch.tensor([0.1, 0.9, 0.49, 0.51])
    args = (verts, colors, faces, torch.ones(B_, 1), intr, bgs, draws, H, H)
    plain, depth = render_scene(*args, cull_backfaces=False)
    blurred, _ = render_scene(*args, cull_backfaces=False, motion_blur=5, motion_blur_prob=0.5)
    apply = torch.tensor([True, False, True, False])
    assert torch.equal(blurred[~apply], plain[~apply])
    assert not torch.equal(blurred[apply], plain[apply])
    # the blur ran on the raw render (zero outside the triangle) before the
    # background took the uncovered pixels
    raw = torch.where((depth > 0)[..., None], plain, torch.zeros_like(plain))
    want = torch.where((depth > 0)[..., None], motion_blur_h(raw, 5), plain)
    assert torch.equal(blurred[apply], want[apply])
    assert "mb" not in render_draws(torch.Generator(), B_, 2, 16, "cpu")


@pytest.mark.parametrize("subsample", [1, 2])
def test_sample_textures_bilinear(jax_ref, subsample):
    from artiboost_torch.artiboost.renderer import SceneTextures, sample_textures

    _, atlas, quv, shade, page = _blur_and_gather_inputs()
    tex = SceneTextures(atlas=torch.from_numpy(atlas), hand_page=None, obj_page=None, uv=None,
                        n_hand_faces=0)
    got = sample_textures(torch.from_numpy(quv), torch.from_numpy(shade),
                          torch.from_numpy(page), tex, bilinear=True, subsample=subsample)
    ref = jax_ref[f"bilinear/{subsample}"]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    nearest = sample_textures(torch.from_numpy(quv), torch.from_numpy(shade),
                              torch.from_numpy(page), tex, subsample=subsample)
    assert float((nearest - got).abs().max()) > 1e-3  # the blend differs from nearest


def test_untextured_synth_batch(jax_ref):
    from artiboost_torch.artiboost.object_library import synthetic_object_library
    from artiboost_torch.artiboost.pose_generator import GeneratedPoses
    from artiboost_torch.artiboost.renderer import default_render_assets
    from artiboost_torch.artiboost.synth_batch import SynthBatch, SynthConfig
    from artiboost_torch.mano.model import get_mano_model
    from artiboost_torch.ops.rasterizer_cuda import raster_rgb, raster_uv

    mano = get_mano_model(device="cpu")
    fn = SynthBatch(mano, synthetic_object_library(["a", "b"], device="cpu"),
                    default_render_assets(mano, device="cpu"),
                    SynthConfig(**BASE, **FLAT_BLUR), device="cpu")
    assert not fn.textured and fn.atlas is None
    assert "mb" in fn.draws(torch.Generator().manual_seed(0), B)["render"]
    draws = _nest(jax_ref, "draws/")
    gen = GeneratedPoses(**_nest(jax_ref, "gen/"))
    n_uv, n_rgb = raster_uv.launches, raster_rgb.launches
    out = fn(gen, torch.arange(B), draws)
    assert (raster_uv.launches, raster_rgb.launches) == (n_uv, n_rgb)  # the twin ran
    prefix = "batch/"
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
            assert err.max() <= 2e-4 and (err <= 1e-5).mean() >= 0.99, (
                err.max(), (err > 1e-5).mean())
        else:
            atol = 1e-4 if k in PIXEL_KEYS else 1e-5
            np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=k)
    # the draws blur one sample and not the other: without the blur the
    # other is unchanged
    apply = jax_ref["draws/render/mb"] < FLAT_BLUR["motion_blur_prob"]
    assert apply.sum() == 1, jax_ref["draws/render/mb"]
    draws["render"]["mb"] = torch.ones(B)
    flat = fn(gen, torch.arange(B), draws)["image"].numpy()
    blurred = np.abs(out["image"].numpy() - flat).max(axis=(1, 2, 3)) > 1e-3
    np.testing.assert_array_equal(blurred, apply)


@pytest.mark.parametrize("renderer", [{"TEXTURED": False}, {"MOTION_BLUR": 7,
                                                            "MOTION_BLUR_PROB": 0.5},
                                      {"BILINEAR": True}])
def test_loader_builds_with_option(renderer):
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.train import slice_config
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "config", "synthetic_smoke.yaml"))
    cfg = copy.deepcopy(cfg)
    cfg["MANAGER"]["RENDERER"].update(renderer)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=4, VAL_LEN=4)
    loader = ArtiBoostLoader(cfg=slice_config(cfg), batch_size=4, device="cpu")
    sc = loader.synth_cfg
    assert (sc.textured, sc.bilinear, sc.motion_blur, sc.motion_blur_prob) == (
        renderer.get("TEXTURED", True), renderer.get("BILINEAR", False),
        renderer.get("MOTION_BLUR", 0), renderer.get("MOTION_BLUR_PROB", 1.0))
    loader.prepare_val()
    batch = next(loader.iter_val())
    assert batch["image"].shape == (4, 128, 128, 3)
    assert torch.isfinite(batch["image"].float()).all()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_reference(sys.argv[1])
