"""The port's on-chip kernel parity gate (counterpart of
``script/chip_parity.py``): the raster kernels run on the card against the
plain raster (``ops/rasterizer.py`` ``rasterize_batch``) and against each
other, on the JAX gate's scenes and at its thresholds.

  * ``check_gouraud_vs_xla`` (:48-57): B2 against the plain raster, depth
    within 1e-3 and every colour channel within 1e-2 on > 99.5 % of pixels;
  * ``check_uv_mode`` (:75-104): B1 against the plain raster, depth, u, v
    and shade within 1e-3, 3e-3, 3e-3 and 2e-2 on > 99.5 % of pixels, and
    page == 5 on every hit;
  * ``check_binned`` (:107-114): B3 at (xbin_w, tile_rows) = (32, 8)
    against B2, atol 1e-6, and against its plain twin bit for bit;
  * ``check_production_lod_uv`` (:117-148): one synth batch of the released
    config (B = 8, CONFIG_LEN_TRAIN and OPG_BATCH_SIZE 16, loader seed 3,
    synth draws from seed 11) rendered once through the kernels and once
    through their plain twins: bit-identical, > 50 % of pixels not black.
    The JAX check compares two out_ct layouts there; the port has no
    out_ct, so the kernel-against-twin comparison takes its place.

``check_out_ct_layouts`` (:60-72) and the out_ct half of
``check_uv_mode`` (:84-92) compare two DMA layouts of one TPU kernel's
output block. That layout does not exist on this card, so they have no
counterpart here.

Usage (on a CUDA card; the kernels build at first use):
    python -m artiboost_torch.chip_parity
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from artiboost_torch.ops.rasterizer import rasterize_batch
from artiboost_torch.ops.rasterizer_cuda import (
    finish_rgb_raster,
    prepare_raster_binned,
    raster_rgb_binned,
    rasterize_batch_rgb,
    rasterize_batch_uv,
)
from artiboost_torch.utils.misc import resolve_device

H = W = 64
RELEASED_CONFIG = "config/ho3dv2_clasbased_artiboost.yaml"


class ParityError(RuntimeError):
    """A kernel disagreed with its reference beyond the gate's threshold."""


def _require(cond: bool, msg: str):
    if not cond:
        raise ParityError(msg)


def _scene(device, seed=0, B=2, V=80, F=160, z0=0.3):
    """script/chip_parity.py ``_scene``: random triangles over 64x64."""
    rng = np.random.RandomState(seed)
    verts = np.zeros((B, V, 3), np.float32)
    verts[..., 0] = rng.rand(B, V) * W
    verts[..., 1] = rng.rand(B, V) * H
    verts[..., 2] = z0 + rng.rand(B, V)
    attrs = rng.rand(B, V, 3).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    return (torch.from_numpy(verts).to(device), torch.from_numpy(attrs).to(device),
            torch.from_numpy(faces).to(device), rng)


def _np(*tensors):
    return [t.cpu().numpy() for t in tensors]


def check_gouraud_vs_xla(device) -> str:
    verts, attrs, faces, _ = _scene(device)
    a_ref, d_ref = _np(*rasterize_batch(verts, attrs, faces, None, H, W, face_chunk=32,
                                        row_chunk=8))
    a, d = _np(*rasterize_batch_rgb(verts, attrs, faces, None, H, W))
    okd = np.isclose(d, d_ref, atol=1e-3).mean()
    oka = np.all(np.isclose(a, a_ref, atol=1e-2), axis=-1).mean()
    _require(okd > 0.995 and oka > 0.995, f"gouraud vs plain raster: depth {okd}, rgb {oka}")
    return f"gouraud_xla d={okd:.4f} a={oka:.4f}"


def check_uv_mode(device) -> str:
    verts, _, faces, rng = _scene(device, seed=2)
    B, V = verts.shape[:2]
    uv = rng.rand(B, V, 2).astype(np.float32)
    s = (rng.rand(B, V) * 3.5).astype(np.float32)
    attrs = torch.from_numpy(np.concatenate(
        [uv, s[..., None], np.full((B, V, 1), 5.0, np.float32)], -1)).to(device)
    a_ref, d_ref = _np(*rasterize_batch(verts, attrs, faces, None, H, W, face_chunk=32,
                                        row_chunk=8))
    quv, shade, page, _win, d = _np(*rasterize_batch_uv(verts, attrs, faces, None, H, W))
    okd = np.isclose(d, d_ref, atol=1e-3)
    u = np.floor(quv / 4096.0) / 4095.0
    v = (quv % 4096.0) / 4095.0
    oku = (np.abs(u - a_ref[..., 0]) < 3e-3)[okd].mean()
    okv = (np.abs(v - a_ref[..., 1]) < 3e-3)[okd].mean()
    oks = (np.abs(shade - a_ref[..., 2]) < 2e-2)[okd].mean()
    _require(okd.mean() > 0.995 and min(oku, okv, oks) > 0.995,
             f"uv vs plain raster: depth {okd.mean()}, u {oku}, v {okv}, shade {oks}")
    _require(bool((page[d > 0] == 5).all()), "uv page channel corrupt")
    return f"uv_mode d={okd.mean():.4f} u={oku:.4f} v={okv:.4f} s={oks:.4f}"


def check_binned(device) -> str:
    verts, attrs, faces, _ = _scene(device, seed=3)
    a_ref, d_ref = _np(*rasterize_batch_rgb(verts, attrs, faces, None, H, W))
    a, d = _np(*rasterize_batch_rgb(verts, attrs, faces, None, H, W, xbin_w=32, tile_rows=8))
    _require(np.allclose(d, d_ref, atol=1e-6) and np.allclose(a, a_ref, atol=1e-6),
             f"binned vs 1-D: depth {np.abs(d - d_ref).max()}, rgb {np.abs(a - a_ref).max()}")
    n_diff = int(((d != d_ref) | np.any(a != a_ref, axis=-1)).sum())
    # the same launch against the binned kernel's plain twin, bit for bit
    inp = prepare_raster_binned(verts, attrs, faces, None, H, W, 32, 8)
    a_twin, d_twin = _np(*finish_rgb_raster(inp, *raster_rgb_binned.twin(*inp.twin_args())))
    _require(np.array_equal(a, a_twin) and np.array_equal(d, d_twin),
             f"binned kernel vs its twin: depth {np.abs(d - d_twin).max()}, "
             f"rgb {np.abs(a - a_twin).max()}")
    return f"binned==1d ({n_diff} px differ), binned==twin"


def check_production_lod_uv(device, B: int = 8) -> str:
    from artiboost_torch.artiboost import renderer
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.datasets.hoquery import Queries
    from artiboost_torch.ops.rasterizer_cuda import finish_uv_raster, prepare_raster, raster_uv
    from artiboost_torch.train import slice_config
    from artiboost_torch.utils.config import load_config
    from artiboost_torch.utils.misc import asset_path

    def uv_twin(*args, **kw):
        inp = prepare_raster(*args, **kw)
        return finish_uv_raster(inp, *raster_uv.twin(*inp.twin_args()))

    cfg = load_config(asset_path(RELEASED_CONFIG))
    manager = dict(slice_config(cfg), CONFIG_LEN_TRAIN=16, OPG_BATCH_SIZE=16)
    loader = ArtiBoostLoader(None, cfg=manager, batch_size=B, seed=3, device=device)
    loader.prepare()
    idx = torch.arange(B, device=device)
    draws = loader.synth_batch_fn.draws(torch.Generator(device=device).manual_seed(11), B)
    kernel_img = loader.synth_batch_fn(loader.generated, idx, draws)[Queries.IMAGE]
    orig = renderer.rasterize_batch_uv
    renderer.rasterize_batch_uv = uv_twin
    try:
        twin_img = loader.synth_batch_fn(loader.generated, idx, draws)[Queries.IMAGE]
    finally:
        renderer.rasterize_batch_uv = orig
    _require(torch.equal(kernel_img, twin_img), "production synth batch: kernel != twin")
    nz = float((kernel_img != -0.5).float().mean())
    _require(nz > 0.5, f"production render degenerate ({nz:.1%} non-bg)")
    return f"production_lod_uv bitexact ({nz:.1%} non-bg px)"


def run_all(production: bool = True, device=None) -> str:
    """Every check in turn on ``device`` (CUDA unless the caller asks for
    the CPU, where the wrappers run their twins) -> the summary line;
    raises ParityError at the first failure."""
    device = resolve_device(device)
    checks = [check_gouraud_vs_xla, check_uv_mode, check_binned]
    if production:
        checks.append(check_production_lod_uv)
    return "; ".join(fn(device) for fn in checks)


def main() -> int:
    device = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    t0 = time.time()
    try:
        summary = run_all(device=device)
    except ParityError as e:
        print(f"CHIP PARITY FAILED ({time.time() - t0:.1f}s): {e}", flush=True)
        return 1
    print(f"CHIP PARITY OK ({time.time() - t0:.1f}s): {summary}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
