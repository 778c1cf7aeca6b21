"""Triangle rasterizer: the CUDA kernels of ``csrc/raster.cu`` behind
ctypes wrappers, their plain PyTorch twins, and the pre/post-kernel work
in torch.

Replaces ``artiboost_tpu/ops/rasterizer_pallas.py`` ``rasterize_batch_pallas``
(:298), whose kernel body is ``_raster_kernel`` (:222) -> ``_tile_core``
(:115), in both pass-2 modes: ``uv_mode=True`` (per-pixel texturing,
``raster_uv``) and the Gouraud mode (``raster_rgb``). The contract is the
TPU kernel's:

  * faces are stably y-sorted (chunk membership decides tie-breaks),
    packed into 128-lane chunks of 16 plane rows with face validity
    folded into ec0 = -1e30 (``_pack_faces`` :71-112, 4 attributes in uv
    mode, 3 in Gouraud mode),
  * a (batch, tile) -> [chunk_start, chunk_end) table bounds each tile's
    scan (:374-393),
  * pass 1 keeps the largest (1/z bits | lane id) key, the earlier chunk
    winning ties; uv pass 2 interpolates and packs (u12, v12) and
    (page8, shade16) of the winner, Gouraud pass 2 quantises the
    winner's r, g, b to 8 bits each and multiplies by float32(1/255),
  * in uv mode the winner id is unsorted back to the caller's face order
    and (page, shade) unpacked (:430-448).

On a CPU tensor a kernel wrapper runs its plain twin; on a CUDA tensor it
launches the kernel or raises. Every a*b+c in the twins is two separately
rounded torch ops, as in the kernels."""
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
TILE_PX = 256       # pixels per tile (kTilePx in raster.cu)
_TWIN_ELEMS = 1 << 24  # bound on the twin's (images, pixels, 128) temporaries


class RasterInputs(NamedTuple):
    """What a kernel reads, plus the sort permutation for the unsort."""

    ranges: torch.Tensor  # (B, T, 2) int32 chunk range per pixel tile
    geom: torch.Tensor    # (B, NC, 16, 128) f32 edge + 1/z planes
    col: torch.Tensor     # (B, NC, 16, 128) f32 attribute/z planes
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
    [ea0, ea1, eb0, eb1, ec0', ec1, wa, wb, wc] and the A attribute planes
    in edge-major order [ea.c0..c(A-1), eb.c0.., ec.c0..]."""
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


def prepare_raster(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                   faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                   height: int, width: int, cull_backfaces: bool = False) -> RasterInputs:
    """Pre-kernel work: screen faces, stable y-sort, packing, range table.
    vert_attrs are (u, v, shade, page) per vertex for the uv kernel (page
    constant per face) or (r, g, b) for the Gouraud kernel."""
    if vert_attrs.shape[-1] not in (3, 4):
        raise ValueError("the raster takes (r, g, b) or (u, v, shade, page) attrs, "
                         f"got {tuple(vert_attrs.shape)}")
    F = faces.shape[-2]
    n_chunks = (F + LANE - 1) // LANE
    n_tiles = (height * width + TILE_PX - 1) // TILE_PX
    sf = build_screen_faces(verts_screen, vert_attrs, faces, face_valid,
                            cull_backfaces=cull_backfaces)
    sf, order = _sort_faces(sf)
    geom, col = pack_faces(sf, n_chunks)
    ranges = chunk_ranges(sf, n_chunks, n_tiles, width)
    return RasterInputs(ranges, geom, col, order, height, width)


def _chunk_boxes(geom: torch.Tensor) -> torch.Tensor:
    """(B, NC, 4) integer pixel box [x0, x1) x [y0, y1) that holds every
    pixel a valid face of the chunk can cover, from the face vertices
    solved back out of the edge planes (vertex k is where lam_k = 1 and the
    other two are 0), widened by 2 pixels. A face covers a pixel only within
    a barycentric margin of 1e-6, far inside that widening."""
    ea0, ea1, eb0, eb1, ec0, ec1 = (geom[:, :, r].double() for r in range(6))
    valid = ec0 > -1e29  # invalid and padded faces carry ec0' = -1e30
    det = ea0 * eb1 - eb0 * ea1
    valid &= det != 0
    det = torch.where(valid, det, 1.0)
    xs, ys = [], []
    for t0, t1 in ((1.0, 0.0), (0.0, 1.0), (0.0, 0.0)):
        r0, r1 = t0 - ec0, t1 - ec1
        xs.append((r0 * eb1 - eb0 * r1) / det)
        ys.append((ea0 * r1 - ea1 * r0) / det)
    x, y = torch.stack(xs, -1), torch.stack(ys, -1)  # (B, NC, 128, 3)
    inf = torch.full_like(x, float("inf"))
    lo_x = torch.where(valid[..., None], x, inf).amin((-1, -2))
    hi_x = torch.where(valid[..., None], x, -inf).amax((-1, -2))
    lo_y = torch.where(valid[..., None], y, inf).amin((-1, -2))
    hi_y = torch.where(valid[..., None], y, -inf).amax((-1, -2))
    box = torch.stack([lo_x - 2, hi_x + 3, lo_y - 2, hi_y + 3], -1)
    return torch.nan_to_num(box, nan=0.0, posinf=1e9, neginf=-1e9).floor().clamp(-1e9, 1e9).long()


def _nearest_face_torch(ranges: torch.Tensor, geom: torch.Tensor, height: int, width: int):
    """Plain pass 1: the same chunk scan, key packing and tie-break as the
    kernel. Each chunk of each image is evaluated only on the pixels of its
    tiles' ranges inside its box (``_chunk_boxes``); outside it no face of
    the chunk can hit, so the keys are the kernel's.
    -> (best key, best chunk), each (B, H * W) int32."""
    B = ranges.shape[0]
    dev = geom.device
    lane = torch.arange(LANE, dtype=torch.int32, device=dev)
    best = torch.zeros((B, height * width), dtype=torch.int32, device=dev)
    best_chunk = torch.zeros_like(best)
    boxes = _chunk_boxes(geom).cpu().tolist()
    ranges_host = ranges.cpu()
    for b in range(B):
        for c in range(geom.shape[1]):
            x0, x1, y0, y1 = boxes[b][c]
            x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, width), min(y1, height)
            if x0 >= x1 or y0 >= y1:
                continue
            yy, xx = torch.meshgrid(torch.arange(y0, y1, device=dev),
                                    torch.arange(x0, x1, device=dev), indexing="ij")
            pix = (yy * width + xx).reshape(-1)
            tile = torch.div(pix, TILE_PX, rounding_mode="floor")
            r = ranges_host[b].to(dev)[tile]
            pix = pix[(r[:, 0] <= c) & (c < r[:, 1])]
            g = geom[b, c][:, None, :]  # (16, 1, 128)
            for p0 in range(0, pix.numel(), _TWIN_ELEMS // LANE):
                p = pix[p0:p0 + _TWIN_ELEMS // LANE]
                x = (p % width).float()[:, None] + 0.5
                y = torch.div(p, width, rounding_mode="floor").float()[:, None] + 0.5
                lam0 = x * g[0] + y * g[2] + g[4]
                lam1 = x * g[1] + y * g[3] + g[5]
                lam2 = 1.0 - lam0 - lam1
                w = x * g[6] + y * g[7] + g[8]
                wbits = w.view(torch.int32)
                hit = (lam0 >= _EPS_EDGE) & (lam1 >= _EPS_EDGE) & (lam2 >= _EPS_EDGE) & (wbits > 0)
                m = torch.where(hit, (wbits & ~_LANE_MASK) | lane, 0).amax(-1)
                bs = best[b, p]
                best_chunk[b, p] = torch.where(m > bs, c, best_chunk[b, p])
                best[b, p] = torch.maximum(bs, m)
    return best, best_chunk


def _winner_planes(ranges, geom, col, height, width):
    """Pass 1 plus the gather of each pixel's winning face planes ->
    (x, y, hit mask, depth, win_sorted, planes (B, H*W, 16))."""
    B = ranges.shape[0]
    n_chunks, n_pix = geom.shape[1], height * width
    best, best_chunk = _nearest_face_torch(ranges, geom, height, width)
    pix = torch.arange(n_pix, device=geom.device)
    x = (pix % width).float() + 0.5
    y = torch.div(pix, width, rounding_mode="floor").float() + 0.5
    hitm = best > 0
    w_rec = torch.clamp_min((best & ~_LANE_MASK).view(torch.float32), 1e-30)
    depth = torch.where(hitm, torch.ones_like(w_rec) / w_rec, 0.0)
    win_sorted = best_chunk * LANE + (best & _LANE_MASK)
    planes = col.transpose(2, 3).reshape(B, n_chunks * LANE, N_ROWS)
    fc = torch.gather(planes, 1, win_sorted.long()[..., None].expand(B, n_pix, N_ROWS))
    return x, y, hitm, depth, win_sorted, fc


def rasterize_batch_uv_torch(ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                             height: int, width: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of the uv kernel: -> (quv, qsp, win_sorted int32,
    depth), each (B, H*W)."""
    x, y, hitm, depth, win_sorted, fc = _winner_planes(ranges, geom, col, height, width)

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


def rasterize_batch_rgb_torch(ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                              height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the Gouraud kernel: -> (rgb (B, H*W, 3) in
    {k * float32(1/255)}, depth (B, H*W))."""
    x, y, hitm, depth, _, fc = _winner_planes(ranges, geom, col, height, width)
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=geom.device)

    def q8(k):
        c = x * fc[..., k] + y * fc[..., k + 3] + fc[..., k + 6]
        return torch.floor(torch.clamp(c * depth, 0.0, 1.0) * 255.0 + 0.5)

    rgb = torch.stack([q8(0), q8(1), q8(2)], dim=-1) * inv255
    return torch.where(hitm[..., None], rgb, torch.zeros_like(rgb)), depth


class RasterLibrary:
    """``csrc/raster.cu`` built once (at first use) and bound with ctypes."""

    source = "raster.cu"

    def __init__(self):
        self._lib = None
        self.build_log = ""

    def get(self):
        if self._lib is None:
            path, self.build_log = build_library(self.source)
            lib = ctypes.CDLL(str(path))
            lib.raster_uv_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p])
            lib.raster_uv_launch.restype = ctypes.c_int
            lib.raster_rgb_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p])
            lib.raster_rgb_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def _check_inputs(name: str, ranges, geom, col, height: int, width: int):
    B, n_tiles, two = ranges.shape
    expect = (B, geom.shape[1], N_ROWS, LANE)
    if (two != 2 or tuple(geom.shape) != expect or tuple(col.shape) != expect
            or ranges.dtype != torch.int32 or geom.dtype != torch.float32
            or col.dtype != torch.float32
            or not all(t.is_contiguous() and t.device == geom.device
                       for t in (ranges, geom, col))):
        raise ValueError(f"{name}: ranges (B, T, 2) int32 and geom/col "
                         f"{expect} float32, contiguous, on one CUDA device")
    if n_tiles * TILE_PX < height * width:
        raise ValueError(f"{name}: the range table covers fewer pixels than the image")


class RasterKernel:
    """ctypes wrapper of one launch function of ``raster.cu``; ``launches``
    counts kernel launches (and nothing else). ``twin`` is the plain
    PyTorch version the wrapper runs for CPU tensors."""

    def __init__(self, name: str, library: RasterLibrary, twin):
        self.name, self.library, self.twin = name, library, twin
        self.launches = 0

    @property
    def build_log(self) -> str:
        return self.library.build_log

    def build(self):
        return self.library.get()

    def __call__(self, ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                 height: int, width: int) -> Tuple[torch.Tensor, ...]:
        if geom.device.type == "cpu":
            return self.twin(ranges, geom, col, height, width)
        if geom.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {geom.device}")
        _check_inputs(self.name, ranges, geom, col, height, width)
        lib = self.build()
        B, n_tiles, _ = ranges.shape
        n_pix = height * width
        f32 = dict(dtype=torch.float32, device=geom.device)
        stream = torch.cuda.current_stream(geom.device).cuda_stream
        head = (ranges.data_ptr(), geom.data_ptr(), col.data_ptr())
        tail = (B, geom.shape[1], n_tiles, n_pix, width, stream)
        if self.name == "raster_uv":
            quv, qsp, depth = (torch.empty((B, n_pix), **f32) for _ in range(3))
            win = torch.empty((B, n_pix), dtype=torch.int32, device=geom.device)
            err = lib.raster_uv_launch(*head, quv.data_ptr(), qsp.data_ptr(), win.data_ptr(),
                                       depth.data_ptr(), *tail)
            out = (quv, qsp, win, depth)
        else:
            rgb = torch.empty((B, n_pix, 3), **f32)
            depth = torch.empty((B, n_pix), **f32)
            err = lib.raster_rgb_launch(*head, rgb.data_ptr(), depth.data_ptr(), *tail)
            out = (rgb, depth)
        if err != 0:
            raise RuntimeError(f"{self.name}_launch failed: CUDA error {err}")
        self.launches += 1
        return out


_library = RasterLibrary()
raster_uv = RasterKernel("raster_uv", _library, rasterize_batch_uv_torch)
raster_rgb = RasterKernel("raster_rgb", _library, rasterize_batch_rgb_torch)


def finish_uv_raster(inp: RasterInputs, quv, qsp, win_sorted, depth):
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


def finish_rgb_raster(inp: RasterInputs, rgb, depth):
    """-> (rgb (B, H, W, 3), depth (B, H, W))."""
    B = rgb.shape[0]
    return rgb.reshape(B, inp.height, inp.width, 3), depth.reshape(B, inp.height, inp.width)


def rasterize_batch_uv(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                       faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                       height: int, width: int, cull_backfaces: bool = False):
    """-> (quv (B, H, W) u12*4096+v12, shade in [0, 4], page int32,
    win (caller face id), depth (0 = background))."""
    inp = prepare_raster(verts_screen, vert_attrs, faces, face_valid, height, width,
                         cull_backfaces)
    out = raster_uv(inp.ranges, inp.geom, inp.col, height, width)
    return finish_uv_raster(inp, *out)


def rasterize_batch_rgb(verts_screen: torch.Tensor, vert_colors: torch.Tensor,
                        faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                        height: int, width: int, cull_backfaces: bool = False):
    """Gouraud raster -> (rgb (B, H, W, 3) 8-bit quantised, depth (B, H, W),
    0 = background)."""
    inp = prepare_raster(verts_screen, vert_colors, faces, face_valid, height, width,
                         cull_backfaces)
    out = raster_rgb(inp.ranges, inp.geom, inp.col, height, width)
    return finish_rgb_raster(inp, *out)
