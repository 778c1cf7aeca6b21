"""The port's x-binned Gouraud raster (kernel B3's pre-kernel work and
plain twin in ``artiboost_torch/ops/rasterizer_cuda.py``), its dispatch
rule, the plain raster (``ops/rasterizer.py`` ``rasterize_batch``) and the
parity gate ``artiboost_torch.chip_parity`` on the CPU.

Tolerances:
  * the binned twin against ``rasterize_batch_pallas(xbin_w=...)`` in
    Pallas interpret mode: bit equality on rgb and depth. The JAX side runs
    in a subprocess with ``--xla_cpu_max_isa=AVX``, as in
    ``tests/test_torch_raster.py``: without FMA instructions XLA rounds
    a*b+c twice, as the kernel and its twin do. It starts with the file and
    runs beside the file's other tests, and the comparison comes last;
  * the binned twin against the 1-D twin: atol 1e-6, the JAX package's
    own bound for that pair (``tests/test_rasterizer_pallas.py:97-98``);
    the per-band sort changes a face's chunk and lane, and so the low 7
    bits of its depth key, which can hand a tie inside 2^-17 relative to
    another face;
  * the plain raster against JAX's ``rasterize_batch``: atol 5e-5 on depth
    and attributes. The interpolated 1/z and attributes are three-term
    sums that XLA contracts into FMAs and torch does not; measured 1.7e-5
    on depth and 7.6e-6 on attributes on the gate's scenes.
The kernel itself runs only on a card: ``chip_smoke.py`` holds it bit for
bit against the twin."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from artiboost_torch import chip_parity
from artiboost_torch.ops import rasterizer_cuda as rc
from artiboost_torch.ops.raster_scenes import random_scene, raster_check_scenes, rgb_attrs
from artiboost_torch.ops.rasterizer import rasterize_batch
from tests._proc import NO_FMA, subprocess_env


def _cases():
    rng = np.random.RandomState(5)
    square = random_scene(rng, 2, 40, 60, 32, 32)
    ragged = random_scene(rng, 2, 40, 60, 24, 40)
    cases = {"square_16x8": (square, False, 16, 8), "square_8x4": (square, False, 8, 4),
             "ragged_16x5": (ragged, False, 16, 5)}
    for name, sc in raster_check_scenes().items():
        for cull in (False, True):
            cases[f"{name}_cull{int(cull)}_16x8"] = (sc, cull, 16, 8)
    return {name: dict(sc, rgb=rgb_attrs(sc), cull=cull, xbin_w=xw, tile_rows=tr)
            for name, (sc, cull, xw, tr) in cases.items()}


CASES = _cases()  # each held bit for bit against the JAX binned raster
# held against the 1-D twin only
CASES_1D = dict(CASES, multi_cull0_8x4=dict(CASES["multi_cull0_16x8"], xbin_w=8, tile_rows=4))


# The JAX side in a fresh process that imports JAX and the JAX raster only
# (see the module docstring): argv = cases npz, output npz.
_JAX_REFERENCE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from artiboost_tpu.ops.rasterizer_pallas import rasterize_batch_pallas

cases, out = np.load(sys.argv[1]), {}
for name in sorted({k.split("/")[0] for k in cases.files}):
    h, w, cull, xbin_w, tile_rows = (int(v) for v in cases[f"{name}/shape"])
    rgb, depth = rasterize_batch_pallas(
        *(jnp.asarray(cases[f"{name}/{k}"]) for k in ("verts", "rgb", "faces", "valid")),
        h, w, cull_backfaces=bool(cull), xbin_w=xbin_w, tile_rows=tile_rows)
    out[f"{name}/rgb"], out[f"{name}/depth"] = np.asarray(rgb), np.asarray(depth)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_run(tmp_path_factory):
    """Starts the JAX reference as the file starts, so that it runs beside
    the file's other tests; ``jax_ref`` waits for it."""
    d = tmp_path_factory.mktemp("raster_binned_ref")
    arrays = {}
    for name, c in CASES.items():
        arrays.update({f"{name}/{k}": c[k] for k in ("verts", "rgb", "faces", "valid")})
        arrays[f"{name}/shape"] = np.array([c["H"], c["W"], c["cull"], c["xbin_w"],
                                            c["tile_rows"]])
    np.savez(d / "cases.npz", **arrays)
    env = subprocess_env(*NO_FMA)
    with open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_REFERENCE, str(d / "cases.npz"),
                                 str(d / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
                                stderr=err)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_ref(_jax_reference_run):
    proc, d = _jax_reference_run
    assert proc.wait(timeout=240) == 0, (d / "stderr.txt").read_text()[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def _binned(c):
    return rc.rasterize_batch_rgb(*(torch.from_numpy(c[k]) for k in ("verts", "rgb", "faces",
                                                                       "valid")),
                                  c["H"], c["W"], cull_backfaces=c["cull"], xbin_w=c["xbin_w"],
                                  tile_rows=c["tile_rows"])


@pytest.mark.parametrize("name", sorted(CASES_1D))
def test_binned_twin_against_1d_twin(name):
    c = CASES_1D[name]
    rgb, depth = _binned(c)
    rgb1, depth1 = rc.rasterize_batch_rgb(*(torch.from_numpy(c[k]) for k in (
        "verts", "rgb", "faces", "valid")), c["H"], c["W"], cull_backfaces=c["cull"])
    torch.testing.assert_close(depth, depth1, rtol=0, atol=1e-6)
    torch.testing.assert_close(rgb, rgb1, rtol=0, atol=1e-6)


def test_binned_layout_and_dispatch(monkeypatch):
    c = CASES["ragged_16x5"]
    args = [torch.from_numpy(c[k]) for k in ("verts", "rgb", "faces", "valid")]
    inp = rc.prepare_raster_binned(*args, 24, 40, 16, 5)
    assert inp.tile == (16, 5) and inp.ranges.shape == (2, 3, 5, 2)  # ceil(40/16), ceil(24/5)
    assert inp.geom.shape == (2, 3, 1, rc.N_ROWS, rc.LANE) and inp.order.shape == (2, 3, 60)
    assert bool((inp.ranges[..., 0] <= inp.ranges[..., 1]).all())

    calls = []

    def spy(name):
        orig = getattr(rc, name)

        def wrapped(*a, **k):
            calls.append(name)
            return orig(*a, **k)

        monkeypatch.setattr(rc, name, wrapped)

    spy("prepare_raster")
    spy("prepare_raster_binned")
    rc.rasterize_batch_rgb(*args, 24, 40, xbin_w=40)  # one band: the 1-D route
    rc.rasterize_batch_rgb(*args, 24, 40, xbin_w=64)
    rc.rasterize_batch_rgb(*args, 24, 40)
    rc.rasterize_batch_rgb(*args, 24, 40, xbin_w=39)
    assert calls == ["prepare_raster"] * 3 + ["prepare_raster_binned"]
    uv = torch.from_numpy(c["attrs"])  # (u, v, shade, page)
    with pytest.raises(ValueError, match="Gouraud only"):
        rc.rasterize_batch_rgb(args[0], uv, args[2], args[3], 24, 40, xbin_w=16)
    rc.rasterize_batch_rgb(args[0], uv, args[2], args[3], 24, 40, xbin_w=40)  # 1-D: taken


def test_binned_kernel_input_checks():
    """What the kernel wrapper refuses before a launch: a range table that
    does not tile the image; and that it takes a tile of more than 2048
    pixels, as JAX's binned raster does (the kernel scans 16 x 16 windows of
    each band, whatever the tile)."""
    c = CASES["ragged_16x5"]
    args = [torch.from_numpy(c[k]) for k in ("verts", "rgb", "faces", "valid")]
    inp = rc.prepare_raster_binned(*args, 24, 40, 16, 5)
    rc._check_inputs("b3", inp.ranges, inp.geom, inp.col, 24, 40, (16, 5))
    with pytest.raises(ValueError, match="do not tile"):
        rc._check_inputs("b3", inp.ranges, inp.geom, inp.col, 24, 40, (16, 4))
    with pytest.raises(ValueError, match="int32"):
        rc._check_inputs("b3", inp.ranges.long(), inp.geom, inp.col, 24, 40, (16, 5))
    one = rc.prepare_raster(*args, 24, 40)  # the 1-D layout takes no tile
    assert one.tile == ()
    with pytest.raises(ValueError, match="one more axis"):
        rc._check_inputs("b3", inp.ranges, one.geom, one.col, 24, 40, (16, 5))
    # one wrapper class for the three kernels: only the binned one takes a tile
    with pytest.raises(ValueError, match="only raster_rgb_binned"):
        rc.raster_rgb(inp)
    with pytest.raises(ValueError, match="only raster_rgb_binned"):
        rc.raster_rgb_binned(one)
    rgb, depth = rc.raster_rgb_binned(inp)  # on the CPU: the twin
    assert rgb.shape == (2, 24 * 40, 3) and depth.shape == (2, 24 * 40)
    big = rc.prepare_raster_binned(*args, 24, 300, 128, 17)
    assert 128 * 17 > 2048
    rc._check_inputs("b3", big.ranges, big.geom, big.col, 24, 300, (128, 17))
    rc._check_tables("b3", rc.kernel_tables(big))


@pytest.mark.parametrize("seed,face_chunk,row_chunk", [(0, 32, 8), (2, 32, 8), (1, 50, 8)])
def test_plain_raster_against_jax(seed, face_chunk, row_chunk):
    import jax.numpy as jnp

    from artiboost_tpu.ops.rasterizer import rasterize_batch as j_rasterize_batch

    verts, attrs, faces, _ = chip_parity._scene("cpu", seed=seed)
    ta, td = rasterize_batch(verts, attrs, faces, None, 64, 64, face_chunk=face_chunk,
                             row_chunk=row_chunk)
    ja, jd = j_rasterize_batch(*(jnp.asarray(t.numpy()) for t in (verts, attrs, faces)), None,
                               64, 64, face_chunk=face_chunk, row_chunk=row_chunk)
    assert (td.numpy() > 0).mean() > 0.3
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=5e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=5e-5)


def test_chip_parity_gate_on_cpu():
    summary = chip_parity.run_all(production=True, device="cpu")
    assert summary.startswith("gouraud_xla") and "binned==1d" in summary
    assert "binned==twin" in summary
    assert "production_lod_uv bitexact" in summary


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_twin_bit_equal_to_jax(jax_ref, name):
    c = CASES[name]
    rgb, depth = _binned(c)
    assert rgb.shape == (c["verts"].shape[0], c["H"], c["W"], 3)
    np.testing.assert_array_equal(rgb.numpy(), jax_ref[f"{name}/rgb"], err_msg=name)
    np.testing.assert_array_equal(depth.numpy(), jax_ref[f"{name}/depth"], err_msg=name)
    hit = depth.numpy() > 0
    assert hit.any() != name.startswith("tie_cull1")  # both tie triangles are back faces
