"""The port's uv raster (``artiboost_torch/ops/rasterizer_cuda.py``)
against the JAX package's ``rasterize_batch_pallas(uv_mode=True)`` run
in Pallas interpret mode on the CPU.

Tolerance: bit equality on quv, shade, page, win and depth, and on the
pre-kernel screen faces, packed planes and range table. XLA's CPU
backend contracts a*b+c into one FMA where the target has one, while
the TPU contract (and the CUDA kernel, ``__fmul_rn``/``__fadd_rn``)
rounds the product and the sum separately; the JAX side therefore runs
in a subprocess with ``--xla_cpu_max_isa=AVX`` (no FMA instructions), the
separately rounded arithmetic of the contract. The kernel itself runs
only on a card: ``chip_smoke.py`` holds it bit-exact against the twin
on the same scenes (``artiboost_torch/ops/raster_scenes.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from artiboost_torch.ops.raster_scenes import raster_check_scenes
from artiboost_torch.ops.rasterizer import build_screen_faces
from artiboost_torch.ops.rasterizer_cuda import (
    LANE,
    TILE_PX,
    _sort_faces,
    chunk_ranges,
    pack_faces,
    rasterize_batch_uv,
)

NO_FMA_ENV = {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_cpu_max_isa=AVX"}


def _cases():
    cases = {}
    for name, sc in raster_check_scenes().items():
        for cull in (False, True):
            cases[f"{name}_cull{int(cull)}"] = dict(sc, cull=cull)
    return cases


CASES = _cases()


def _jax_reference(cases, path_out):
    """Subprocess body: the JAX raster and its pre-kernel pieces."""
    import jax
    import jax.numpy as jnp

    from artiboost_tpu.ops.rasterizer import build_screen_faces as jbsf
    from artiboost_tpu.ops.rasterizer_pallas import _pack_faces, rasterize_batch_pallas

    out = {}
    for name, c in cases.items():
        v, a, f, fv = (jnp.asarray(c[k]) for k in ("verts", "attrs", "faces", "valid"))
        res = rasterize_batch_pallas(v, a, f, fv, c["H"], c["W"], tile_px=TILE_PX,
                                     uv_mode=True, cull_backfaces=c["cull"])
        for k, r in zip(("quv", "shade", "page", "win", "depth"), res):
            out[f"{name}/{k}"] = np.asarray(r)
        sf = jax.vmap(lambda vv, aa, mm: jbsf(vv, aa, f, mm, cull_backfaces=c["cull"]))(v, a, fv)
        for k in sf._fields:
            out[f"{name}/sf_{k}"] = np.asarray(getattr(sf, k))
        order = jnp.argsort(jnp.where(sf.valid > 0, sf.bbox[..., 1], 1e30), axis=1)
        sfs = jax.tree_util.tree_map(lambda t: jnp.take_along_axis(
            t, order.reshape(order.shape + (1,) * (t.ndim - 2)), axis=1), sf)
        nc = (f.shape[0] + LANE - 1) // LANE
        geom, col = jax.vmap(lambda s: _pack_faces(s, nc, n_attr=4))(sfs)
        out[f"{name}/geom"], out[f"{name}/col"] = np.asarray(geom), np.asarray(col)
        out[f"{name}/sorted_bbox"] = np.asarray(sfs.bbox)
        out[f"{name}/sorted_valid"] = np.asarray(sfs.valid)
    np.savez(path_out, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("raster_ref")
    out = d / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **NO_FMA_ENV,
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port(c):
    return rasterize_batch_uv(torch.from_numpy(c["verts"]), torch.from_numpy(c["attrs"]),
                              torch.from_numpy(c["faces"]), torch.from_numpy(c["valid"]),
                              c["H"], c["W"], cull_backfaces=c["cull"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_raster_outputs_bit_equal(jax_ref, name):
    c = CASES[name]
    quv, shade, page, win, depth = _port(c)
    for k, t in (("quv", quv), ("shade", shade), ("page", page), ("win", win), ("depth", depth)):
        ref = jax_ref[f"{name}/{k}"]
        got = t.numpy().astype(ref.dtype)
        assert got.shape == ref.shape, (k, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=f"{name}/{k}")
    hit = depth.numpy() > 0
    if name == "tie_cull1":  # both triangles have positive screen area: back faces
        assert not hit.any()
    else:
        assert hit.any() and (~hit).any()
    if name == "tie_cull0":  # the near face (caller id 1, page 7) wins everywhere
        assert (win.numpy()[hit] == 1).all() and (page.numpy()[hit] == 7).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_screen_faces_packing_and_ranges(jax_ref, name):
    c = CASES[name]
    sf = build_screen_faces(torch.from_numpy(c["verts"]), torch.from_numpy(c["attrs"]),
                            torch.from_numpy(c["faces"]), torch.from_numpy(c["valid"]),
                            cull_backfaces=c["cull"])
    for k in sf._fields:
        np.testing.assert_array_equal(getattr(sf, k).numpy(), jax_ref[f"{name}/sf_{k}"],
                                      err_msg=f"{name}/sf_{k}")
    sfs, _ = _sort_faces(sf)
    nc = (c["faces"].shape[0] + LANE - 1) // LANE
    geom, col = pack_faces(sfs, nc)
    np.testing.assert_array_equal(geom.numpy(), jax_ref[f"{name}/geom"])
    np.testing.assert_array_equal(col.numpy(), jax_ref[f"{name}/col"])

    # the range table against the rule on the JAX-sorted extents: a
    # chunk [start, end) per tile, end = #chunks with ymin <= tile_ymax,
    # start = #prefix chunks whose running-max ymax < tile_ymin
    H, W = c["H"], c["W"]
    n_tiles = (H * W + TILE_PX - 1) // TILE_PX
    ranges = chunk_ranges(sfs, nc, n_tiles, W).numpy()
    bbox, valid = jax_ref[f"{name}/sorted_bbox"], jax_ref[f"{name}/sorted_valid"]
    pad = nc * LANE - valid.shape[1]
    ymin = np.pad(np.where(valid > 0, bbox[..., 1], 1e30), ((0, 0), (0, pad)),
                  constant_values=1e30).reshape(len(valid), nc, LANE).min(-1)
    ymax = np.pad(np.where(valid > 0, bbox[..., 3], -1e30), ((0, 0), (0, pad)),
                  constant_values=-1e30).reshape(len(valid), nc, LANE).max(-1)
    for t in range(n_tiles):
        lo = (t * TILE_PX) // W
        hi = ((t + 1) * TILE_PX - 1) // W + 1
        end = (ymin <= hi).sum(-1)
        start = (np.maximum.accumulate(ymax, axis=1) < lo).sum(-1)
        np.testing.assert_array_equal(ranges[:, t, 1], end)
        np.testing.assert_array_equal(ranges[:, t, 0], np.minimum(start, end))


def test_raster_under_xla_fma_contraction():
    """In-process JAX keeps XLA's default contraction (a*b+c as one FMA on
    hosts that have it): the winners still agree, and depth moves by at
    most one key step (2^-16 relative, the low 7 mantissa bits hold the
    lane id) where the contracted plane rounds across a key boundary."""
    import jax.numpy as jnp

    from artiboost_tpu.ops.rasterizer_pallas import rasterize_batch_pallas

    c = CASES["multi_cull0"]
    ref = rasterize_batch_pallas(*(jnp.asarray(c[k]) for k in ("verts", "attrs", "faces", "valid")),
                                 c["H"], c["W"], tile_px=TILE_PX, uv_mode=True)
    got = [t.numpy() for t in _port(c)]
    quv, shade, page, win, depth = (np.asarray(r) for r in ref)
    assert (got[3] == win).mean() >= 0.999 and (got[2] == page).mean() >= 0.999
    hit = (depth > 0) & (got[4] > 0)
    assert np.all(np.abs(got[4] - depth)[hit] <= 2.0 ** -15 * depth[hit])
    assert (got[4] == depth).mean() >= 0.97
    # a moved depth can move a 12-bit uv or a 16-bit shade quantization step
    assert (got[0] == quv).mean() >= 0.98 and (got[1] == shade).mean() >= 0.98
    assert np.all(np.abs(got[1] - shade)[hit] <= 2 * 4.0 / 65535.0)


if __name__ == "__main__":
    # JAX reference in a fresh process (see the module docstring)
    import jax

    jax.config.update("jax_platforms", "cpu")
    _jax_reference(CASES, sys.argv[1])
