"""Per-pixel UV triangle rasterizer: the CUDA kernel
``csrc/raster_uv.cu`` behind a ctypes wrapper, its plain PyTorch twin,
and the pre/post-kernel work in torch.

Replaces ``artiboost_tpu/ops/rasterizer_pallas.py`` ``rasterize_batch_pallas``
(:298) with ``uv_mode=True``, whose kernel body is ``_raster_kernel``
(:222) -> ``_tile_core`` (:115). The contract is the TPU kernel's:

  * faces are stably y-sorted (chunk membership decides tie-breaks),
    packed into 128-lane chunks of 16 plane rows with face validity
    folded into ec0 = -1e30 (``_pack_faces`` :71-112),
  * a (batch, tile) -> [chunk_start, chunk_end) table bounds each tile's
    scan (:374-393),
  * pass 1 keeps the largest (1/z bits | lane id) key, the earlier chunk
    winning ties; pass 2 interpolates and packs (u12, v12) and
    (page8, shade16) of the winner,
  * the winner id is unsorted back to the caller's face order and
    (page, shade) unpacked (:430-448).

On a CPU tensor ``UVRasterKernel.__call__`` runs the plain twin; on a
CUDA tensor it launches the kernel or raises. Every a*b+c in the twin is
two separately rounded torch ops, as in the kernel."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from artiboost_torch.ops.cuda_build import build_library
from artiboost_torch.ops.rasterizer import ScreenFace, build_screen_faces

_BIG = 1e30
_EPS_EDGE = -1e-6
LANE = 128          # faces per chunk
N_ROWS = 16         # plane rows per chunk
_LANE_MASK = 0x7F   # low 7 mantissa bits of the depth key carry the lane id
TILE_PX = 256       # pixels per tile (kTilePx in raster_uv.cu)


class UVRasterInputs(NamedTuple):
    """What the kernel reads, plus the sort permutation for the unsort."""

    ranges: torch.Tensor  # (B, T, 2) int32 chunk range per pixel tile
    geom: torch.Tensor    # (B, NC, 16, 128) f32 edge + 1/z planes
    col: torch.Tensor     # (B, NC, 16, 128) f32 (u, v, shade, page)/z planes
    order: torch.Tensor   # (B, F) int64 sorted -> caller face id
    height: int
    width: int


def _sort_faces(sf: ScreenFace) -> Tuple[ScreenFace, torch.Tensor]:
    """Stable sort of every per-face field by screen ymin (invalid last)."""
    key = torch.where(sf.valid > 0, sf.bbox[..., 1], torch.full_like(sf.valid, _BIG))
    order = torch.sort(key, dim=1, stable=True).indices

    def take(a):
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2)).expand_as(a)
        return torch.gather(a, 1, idx)

    return ScreenFace(*(take(a) for a in sf)), order


def _sum3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) . (..., 3) as ((a0 b0 + a1 b1) + a2 b2), a fixed order."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def pack_faces(sf: ScreenFace, n_chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted ScreenFace -> (geom, col), each (B, NC, 16, 128): geometry
    [ea0, ea1, eb0, eb1, ec0', ec1, wa, wb, wc] and attribute planes in
    edge-major order [ea.c0..c3, eb.c0..c3, ec.c0..c3]."""
    B, F = sf.valid.shape
    pad = n_chunks * LANE - F

    def p(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))

    ea, eb, ec, iz = p(sf.edge_a), p(sf.edge_b), p(sf.edge_c), p(sf.inv_z)
    aoz = p(sf.attr_over_z)
    valid = torch.nn.functional.pad(sf.valid, (0, pad))
    ec0 = torch.where(valid > 0, ec[..., 0], torch.full_like(valid, -_BIG))
    rows = [ea[..., 0], ea[..., 1], eb[..., 0], eb[..., 1], ec0, ec[..., 1],
            _sum3(ea, iz), _sum3(eb, iz), _sum3(ec, iz)]
    zeros = torch.zeros_like(ec0)
    geom = torch.stack(rows + [zeros] * (N_ROWS - len(rows)), dim=-1)
    n_attr = aoz.shape[-1]
    crows = [_sum3(e, aoz[..., ch]) for e in (ea, eb, ec) for ch in range(n_attr)]
    col = torch.stack(crows + [zeros] * (N_ROWS - len(crows)), dim=-1)
    shape = (B, n_chunks, LANE, N_ROWS)
    return (geom.reshape(shape).transpose(2, 3).contiguous(),
            col.reshape(shape).transpose(2, 3).contiguous())


def chunk_ranges(sf: ScreenFace, n_chunks: int, n_tiles: int, width: int) -> torch.Tensor:
    """(B, T, 2) int32 [start, end) of the sorted chunks whose y-extent can
    touch each tile: chunks are ymin-sorted, so the first chunk with
    ymin > tile_ymax ends the scan, and the prefix whose running-max
    ymax < tile_ymin lies strictly above the tile."""
    B, F = sf.valid.shape
    pad = n_chunks * LANE - F
    big = torch.full_like(sf.valid, _BIG)
    fymin = torch.nn.functional.pad(torch.where(sf.valid > 0, sf.bbox[..., 1], big),
                                    (0, pad), value=_BIG)
    fymax = torch.nn.functional.pad(torch.where(sf.valid > 0, sf.bbox[..., 3], -big),
                                    (0, pad), value=-_BIG)
    chunk_ymin = fymin.reshape(B, n_chunks, LANE).amin(-1)
    chunk_ymax = fymax.reshape(B, n_chunks, LANE).amax(-1)
    tile = torch.arange(n_tiles, device=sf.valid.device)
    tile_ymin = torch.div(tile * TILE_PX, width, rounding_mode="floor").float()
    tile_ymax = torch.div((tile + 1) * TILE_PX - 1, width, rounding_mode="floor").float() + 1.0
    cummax_ymax = torch.cummax(chunk_ymax, dim=1).values
    ends = (chunk_ymin[:, None, :] <= tile_ymax[None, :, None]).sum(-1)
    starts = (cummax_ymax[:, None, :] < tile_ymin[None, :, None]).sum(-1)
    return torch.stack([torch.minimum(starts, ends), ends], dim=-1).to(torch.int32).contiguous()


def prepare_uv_raster(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                      faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                      height: int, width: int,
                      cull_backfaces: bool = False) -> UVRasterInputs:
    """Pre-kernel work: screen faces, stable y-sort, packing, range table.
    vert_attrs are (u, v, shade, page) per vertex (page constant per face)."""
    if vert_attrs.shape[-1] != 4:
        raise ValueError(f"uv raster expects (u, v, shade, page) attrs, got {vert_attrs.shape}")
    F = faces.shape[-2]
    n_chunks = (F + LANE - 1) // LANE
    n_tiles = (height * width + TILE_PX - 1) // TILE_PX
    sf = build_screen_faces(verts_screen, vert_attrs, faces, face_valid,
                            cull_backfaces=cull_backfaces)
    sf, order = _sort_faces(sf)
    geom, col = pack_faces(sf, n_chunks)
    ranges = chunk_ranges(sf, n_chunks, n_tiles, width)
    return UVRasterInputs(ranges, geom, col, order, height, width)


def _pixel_centers(n_tiles: int, width: int, device):
    pix = torch.arange(n_tiles * TILE_PX, device=device)
    x = (pix % width).float() + 0.5
    y = torch.div(pix, width, rounding_mode="floor").float() + 0.5
    return pix, x, y


def rasterize_batch_uv_torch(ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                             height: int, width: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the kernel: the same chunk scan, key packing
    and tie-break. -> (quv, qsp, win_sorted int32, depth), each (B, H*W)."""
    B, n_tiles, _ = ranges.shape
    n_chunks = geom.shape[1]
    n_pix = height * width
    pix, x, y = _pixel_centers(n_tiles, width, geom.device)
    P = pix.shape[0]
    tile = torch.div(pix, TILE_PX, rounding_mode="floor")
    start = ranges[:, tile, 0]  # (B, P)
    end = ranges[:, tile, 1]
    lane = torch.arange(LANE, dtype=torch.int32, device=geom.device)
    xs, ys = x[None, :, None], y[None, :, None]
    slab = max(1, (1 << 24) // (P * LANE))  # bound the (b, P, 128) temporaries

    best = torch.zeros((B, P), dtype=torch.int32, device=geom.device)
    best_chunk = torch.zeros_like(best)
    for c in range(n_chunks):
        in_range = (start <= c) & (c < end)
        if not bool(in_range.any()):
            continue
        for b0 in range(0, B, slab):
            g = geom[b0:b0 + slab, c][:, :, None, :]  # (b, 16, 1, 128)
            lam0 = xs * g[:, 0] + ys * g[:, 2] + g[:, 4]
            lam1 = xs * g[:, 1] + ys * g[:, 3] + g[:, 5]
            lam2 = 1.0 - lam0 - lam1
            w = xs * g[:, 6] + ys * g[:, 7] + g[:, 8]
            wbits = w.view(torch.int32)
            hit = (lam0 >= _EPS_EDGE) & (lam1 >= _EPS_EDGE) & (lam2 >= _EPS_EDGE) & (wbits > 0)
            key = torch.where(hit, (wbits & ~_LANE_MASK) | lane, 0)
            m = torch.where(in_range[b0:b0 + slab], key.amax(-1), 0)
            bs = best[b0:b0 + slab]
            best_chunk[b0:b0 + slab] = torch.where(m > bs, c, best_chunk[b0:b0 + slab])
            best[b0:b0 + slab] = torch.maximum(bs, m)

    best, best_chunk, x, y = best[:, :n_pix], best_chunk[:, :n_pix], x[:n_pix], y[:n_pix]
    hitm = best > 0
    w_rec = (best & ~_LANE_MASK).view(torch.float32)
    w_rec = torch.clamp_min(w_rec, 1e-30)
    depth = torch.where(hitm, torch.ones_like(w_rec) / w_rec, 0.0)
    lane_w = best & _LANE_MASK
    win_sorted = best_chunk * LANE + lane_w

    planes = col.transpose(2, 3).reshape(B, n_chunks * LANE, N_ROWS)
    fc = torch.gather(planes, 1, win_sorted.long()[..., None].expand(B, n_pix, N_ROWS))

    def interp(k):
        return x * fc[..., k] + y * fc[..., k + 4] + fc[..., k + 8]

    u, v, s, p = interp(0), interp(1), interp(2), interp(3)

    def q12(a):
        return torch.floor(torch.clamp(a * depth, 0.0, 1.0) * 4095.0 + 0.5)

    quv = q12(u) * 4096.0 + q12(v)
    qsp = (torch.floor(torch.clamp(p * depth, 0.0, 255.0) + 0.5) * 65536.0
           + torch.floor(torch.clamp(s * depth * 0.25, 0.0, 1.0) * 65535.0 + 0.5))
    zero = torch.zeros_like(depth)
    return (torch.where(hitm, quv, zero), torch.where(hitm, qsp, zero),
            win_sorted.to(torch.int32), depth)


class UVRasterKernel:
    """ctypes wrapper of ``raster_uv_launch``; ``launches`` counts kernel
    launches (and nothing else)."""

    source = "raster_uv.cu"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self.build_log = ""

    def build(self):
        if self._lib is None:
            path, self.build_log = build_library(self.source)
            lib = ctypes.CDLL(str(path))
            fn = lib.raster_uv_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                 height: int, width: int) -> Tuple[torch.Tensor, ...]:
        if geom.device.type == "cpu":
            return rasterize_batch_uv_torch(ranges, geom, col, height, width)
        if geom.device.type != "cuda":
            raise ValueError(f"uv raster: unsupported device {geom.device}")
        B, n_tiles, two = ranges.shape
        n_chunks = geom.shape[1]
        expect = (B, n_chunks, N_ROWS, LANE)
        if (two != 2 or tuple(geom.shape) != expect or tuple(col.shape) != expect
                or ranges.dtype != torch.int32 or geom.dtype != torch.float32
                or col.dtype != torch.float32
                or not all(t.is_contiguous() and t.device == geom.device
                           for t in (ranges, geom, col))):
            raise ValueError("uv raster: ranges (B, T, 2) int32 and geom/col "
                             f"{expect} float32, contiguous, on one CUDA device")
        if n_tiles * TILE_PX < height * width:
            raise ValueError("uv raster: the range table covers fewer pixels than the image")
        lib = self.build()
        n_pix = height * width
        quv = torch.empty((B, n_pix), dtype=torch.float32, device=geom.device)
        qsp = torch.empty_like(quv)
        depth = torch.empty_like(quv)
        win = torch.empty((B, n_pix), dtype=torch.int32, device=geom.device)
        stream = torch.cuda.current_stream(geom.device).cuda_stream
        err = lib.raster_uv_launch(
            ranges.data_ptr(), geom.data_ptr(), col.data_ptr(), quv.data_ptr(),
            qsp.data_ptr(), win.data_ptr(), depth.data_ptr(),
            B, n_chunks, n_tiles, n_pix, width, stream)
        if err != 0:
            raise RuntimeError(f"raster_uv_launch failed: CUDA error {err}")
        self.launches += 1
        return quv, qsp, win, depth


raster_uv = UVRasterKernel()


def finish_uv_raster(inp: UVRasterInputs, quv, qsp, win_sorted, depth):
    """Post-kernel work: winner id back to caller order, (page, shade)
    unpack -> (quv, shade, page int32, win int64, depth), each (B, H, W)."""
    B = quv.shape[0]
    F = inp.order.shape[1]
    shape = (B, inp.height, inp.width)
    win = torch.gather(inp.order, 1, torch.clamp(win_sorted.long(), 0, F - 1))
    page = torch.floor(qsp * (1.0 / 65536.0))
    shade = (qsp - page * 65536.0) * (4.0 / 65535.0)
    return (quv.reshape(shape), shade.reshape(shape), page.to(torch.int32).reshape(shape),
            win.reshape(shape), depth.reshape(shape))


def rasterize_batch_uv(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                       faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                       height: int, width: int, cull_backfaces: bool = False):
    """-> (quv (B, H, W) u12*4096+v12, shade in [0, 4], page int32,
    win (caller face id), depth (0 = background))."""
    inp = prepare_uv_raster(verts_screen, vert_attrs, faces, face_valid, height, width,
                            cull_backfaces)
    out = raster_uv(inp.ranges, inp.geom, inp.col, height, width)
    return finish_uv_raster(inp, *out)
