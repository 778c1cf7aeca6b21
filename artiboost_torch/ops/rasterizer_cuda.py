"""Triangle rasterizer: the CUDA kernels of ``csrc/raster.cu`` behind
ctypes wrappers, their plain PyTorch twins, and the pre/post-kernel work
in torch.

Replaces ``artiboost_tpu/ops/rasterizer_pallas.py`` ``rasterize_batch_pallas``
(:298), whose kernel body is ``_raster_kernel`` (:222) -> ``_tile_core``
(:115), in both pass-2 modes: ``uv_mode=True`` (per-pixel texturing,
``raster_uv``) and the Gouraud mode (``raster_rgb``); and its x-binned
Gouraud route ``_rasterize_binned`` (:469) -> ``_raster_kernel_binned``
(:272) (``raster_rgb_binned``, tiles of tile_rows x xbin_w pixels over
per-band face lists, ``prepare_raster_binned``). The contract is the TPU
kernel's:

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

No kernel reads the JAX kernel's range tables: the three kernels scan
square pixel windows of side ``RASTER_TILE`` (B3's in each x-band) and
read three tables of their own (``kernel_tables``: ``tile_ranges``,
``chunk_boxes``, ``face_boxes``, per band for B3), which only narrow the
faces a window evaluates to those whose pixel box meets it.
``prepare_raster`` and ``prepare_raster_binned`` build them for planes on
the card. The twins read the JAX kernel's tables, as it does: the 1-D one
is built where a twin runs (``RasterInputs.twin_args``), the binned one by
``prepare_raster_binned``.

On a CPU tensor a kernel wrapper runs its plain twin; on a CUDA tensor it
launches the kernel or raises. Every a*b+c in the twins is two separately
rounded torch ops, as in the kernels."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from artiboost_torch.ops.cuda_build import build_library
from artiboost_torch.ops.rasterizer import ScreenFace, build_screen_faces
from artiboost_torch.utils.profiling import trace

_BIG = 1e30
_EPS_EDGE = -1e-6
LANE = 128          # faces per chunk
N_ROWS = 16         # plane rows per chunk
_LANE_MASK = 0x7F   # low 7 mantissa bits of the depth key carry the lane id
TILE_PX = 256       # pixels per tile of the 1-D range table (the JAX kernel's tile_px)
RASTER_TILE = 16  # side of the kernels' square pixel windows (kTile in raster.cu)
RASTER_REGION = 8  # each warp of those kernels scans for an 8 x 8 region of its window (kRegion)
BOX_LIMIT = 10 ** 9  # boxes are clamped to +-BOX_LIMIT; an empty one is [BOX_LIMIT, -BOX_LIMIT)
_TWIN_ELEMS = 1 << 24  # bound on the twin's (images, pixels, 128) temporaries


class RasterInputs(NamedTuple):
    """What a kernel and its twin read, plus the sort permutation for the
    unsort. The binned raster's arrays carry a band axis after the batch
    axis, its ``ranges`` are keyed by (image, band, y-tile) and ``tile`` is
    (xbin_w, tile_rows). The uv and Gouraud layout has ``tile`` () and no
    ``ranges``: its twins' 1-D range table is built from the chunk
    ``extents`` (``twin_args``). Both keep the ``extents`` of every image
    (B3: of every band of one), and on the card the kernels' own tables
    (``kernel_tables``), with the planes' leading axes."""

    geom: torch.Tensor    # (B, NC, 16, 128) f32 edge + 1/z planes; binned (B, NB, NC, 16, 128)
    col: torch.Tensor     # (B, NC, 16, 128) f32 attribute/z planes; binned as geom
    order: torch.Tensor   # (B, F) int64 sorted -> caller face id; binned (B, NB, F)
    height: int
    width: int
    ranges: Optional[torch.Tensor] = None  # binned: (B, NB, YT, 2) int32 chunk range per tile
    tile: Tuple[int, ...] = ()
    extents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # ``_chunk_extents`` (B[*NB], NC)
    tiles: Optional[torch.Tensor] = None      # (B, [NB,] TY, 2) int32 chunk range per window row
    chunk_box: Optional[torch.Tensor] = None  # (B, [NB,] NC, 4) int32 (x0, x1, y0, y1)
    face_box: Optional[torch.Tensor] = None   # (B, [NB,] NC, 128, 4) int32 (x0, x1, y0, y1)

    def twin_args(self) -> tuple:
        """The plain twin's arguments. The uv and Gouraud twins' 1-D range
        table (``chunk_ranges``) is built here, where a twin runs."""
        if self.tile:
            return (self.ranges, self.geom, self.col, self.height, self.width) + self.tile
        n_tiles = -(-self.height * self.width // TILE_PX)
        return (_pixel_tile_ranges(self.extents, n_tiles, self.width), self.geom, self.col,
                self.height, self.width)


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
    touch each TILE_PX-pixel tile (:383-384: tile_ymax is the last row's
    index plus 1)."""
    return _pixel_tile_ranges(_chunk_extents(sf, n_chunks), n_tiles, width)


def _pixel_tile_ranges(extents: Tuple[torch.Tensor, torch.Tensor], n_tiles: int,
                       width: int) -> torch.Tensor:
    """``chunk_ranges`` from ``_chunk_extents``."""
    tile = torch.arange(n_tiles, device=extents[0].device)
    tile_ymin = torch.div(tile * TILE_PX, width, rounding_mode="floor").float()
    tile_ymax = torch.div((tile + 1) * TILE_PX - 1, width, rounding_mode="floor").float() + 1.0
    return _ranges_for_rows(extents, tile_ymin, tile_ymax)


def _ranges_for_rows(extents: Tuple[torch.Tensor, torch.Tensor], tile_ymin: torch.Tensor,
                     tile_ymax: torch.Tensor) -> torch.Tensor:
    """(N, T, 2) int32 [start, end) of the sorted chunks whose y-extent can
    touch tiles spanning rows [tile_ymin, tile_ymax]: chunks are
    ymin-sorted, so the first chunk with ymin > tile_ymax ends the scan,
    and the prefix whose running-max ymax < tile_ymin lies strictly above
    the tile. ``extents`` = ``_chunk_extents``."""
    chunk_ymin, cummax_ymax = extents
    ends = (chunk_ymin[:, None, :] <= tile_ymax[None, :, None]).sum(-1)
    starts = (cummax_ymax[:, None, :] < tile_ymin[None, :, None]).sum(-1)
    return torch.stack([torch.minimum(starts, ends), ends], dim=-1).to(torch.int32).contiguous()


def _chunk_extents(sf: ScreenFace, n_chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (N, NC) smallest ymin of each sorted chunk's valid faces and the
    running max over the chunks of their largest ymax."""
    B, F = sf.valid.shape
    pad = n_chunks * LANE - F
    big = torch.full_like(sf.valid, _BIG)
    fymin = torch.nn.functional.pad(torch.where(sf.valid > 0, sf.bbox[..., 1], big),
                                    (0, pad), value=_BIG)
    fymax = torch.nn.functional.pad(torch.where(sf.valid > 0, sf.bbox[..., 3], -big),
                                    (0, pad), value=-_BIG)
    chunk_ymin = fymin.reshape(B, n_chunks, LANE).amin(-1)
    chunk_ymax = fymax.reshape(B, n_chunks, LANE).amax(-1)
    return chunk_ymin, torch.cummax(chunk_ymax, dim=1).values


def tile_ranges(extents: Tuple[torch.Tensor, torch.Tensor], height: int) -> torch.Tensor:
    """(N, TY, 2) int32 [start, end) of the sorted chunks whose y-extent can
    touch the rows [ty RASTER_TILE, (ty + 1) RASTER_TILE) of a row of windows
    (the rule of ``chunk_ranges``, tile_ymax the last row's index plus 1),
    from ``_chunk_extents``."""
    ty = torch.arange(-(-height // RASTER_TILE), dtype=torch.float32, device=extents[0].device)
    return _ranges_for_rows(extents, ty * RASTER_TILE, (ty + 1) * RASTER_TILE)


def face_boxes(geom: torch.Tensor) -> torch.Tensor:
    """(B, NC, 16, 128) packed planes -> (B, NC, 128, 4) int32 pixel box
    [x0, x1) x [y0, y1) that holds every pixel the face can cover: its
    vertices solved back out of the edge planes in float64 (vertex k is
    where lam_k = 1 and the other two are 0), widened by 2 pixels. A face
    covers a pixel only within a barycentric margin of 1e-6, far inside that
    widening. Invalid and padded faces (ec0' = -1e30) and faces whose planes
    are singular get the empty box. The solve stays finite: float32 planes
    cannot overflow float64 products."""
    # the three vertices at once, in a trailing axis: (t0, t1) = (1, 0), (0, 1), (0, 0)
    ea0, ea1, eb0, eb1, ec0, ec1 = geom[:, :, :6, :, None].double().unbind(2)
    det = ea0 * eb1 - eb0 * ea1
    valid = (ec0 > -1e29) & (det != 0)  # invalid and padded faces carry ec0' = -1e30
    det = torch.where(valid, det, 1.0)
    t = torch.eye(2, 3, dtype=det.dtype, device=det.device)
    r0, r1 = t[0] - ec0, t[1] - ec1
    xy = torch.stack([(r0 * eb1 - eb0 * r1) / det, (ea0 * r1 - ea1 * r0) / det], -2)
    lim = float(BOX_LIMIT)
    lo = torch.where(valid, xy.amin(-1) - 2, lim)  # (B, NC, 128, 2): x, y
    hi = torch.where(valid, xy.amax(-1) + 3, -lim)
    return torch.stack([lo, hi], -1).flatten(-2).clamp(-lim, lim).floor().to(torch.int32)


def chunk_boxes(face_box: torch.Tensor) -> torch.Tensor:
    """(..., NC, 128, 4) face boxes -> (..., NC, 4) int32 box of each chunk,
    the smallest that holds its faces' boxes (empty when they all are)."""
    return torch.stack([face_box[..., 0].amin(-1), face_box[..., 1].amax(-1),
                        face_box[..., 2].amin(-1), face_box[..., 3].amax(-1)], -1).contiguous()


def kernel_tables(inp: RasterInputs) -> RasterInputs:
    """``inp`` with the kernels' own tables: each row of windows' chunk
    range (``tile_ranges``), each face's pixel box (``face_boxes``) and each
    chunk's (``chunk_boxes``); in the binned layout those of every band,
    each band's planes taken as an image."""
    lead = tuple(inp.geom.shape[:-3])
    fbox = face_boxes(inp.geom.reshape((-1,) + tuple(inp.geom.shape[-3:])))
    tiles = tile_ranges(inp.extents, inp.height)
    return inp._replace(tiles=tiles.reshape(lead + tiles.shape[1:]),
                        chunk_box=chunk_boxes(fbox).reshape(lead + (fbox.shape[1], 4)),
                        face_box=fbox.reshape(lead + fbox.shape[1:]))


def prepare_raster(verts_screen: torch.Tensor, vert_attrs: torch.Tensor,
                   faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                   height: int, width: int, cull_backfaces: bool = False) -> RasterInputs:
    """Pre-kernel work: screen faces, stable y-sort, packing and the chunk
    extents, and for planes on the card the kernels' tables
    (``kernel_tables``). vert_attrs are (u, v, shade, page) per vertex for
    the uv kernel (page constant per face) or (r, g, b) for the Gouraud
    kernel."""
    if vert_attrs.shape[-1] not in (3, 4):
        raise ValueError("the raster takes (r, g, b) or (u, v, shade, page) attrs, "
                         f"got {tuple(vert_attrs.shape)}")
    with trace("raster/prepare_raster"):
        n_chunks = (faces.shape[-2] + LANE - 1) // LANE
        sf = build_screen_faces(verts_screen, vert_attrs, faces, face_valid,
                                cull_backfaces=cull_backfaces)
        sf, order = _sort_faces(sf)
        geom, col = pack_faces(sf, n_chunks)
        inp = RasterInputs(geom, col, order, height, width, extents=_chunk_extents(sf, n_chunks))
        return kernel_tables(inp) if geom.is_cuda else inp


def prepare_raster_binned(verts_screen: torch.Tensor, vert_colors: torch.Tensor,
                          faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                          height: int, width: int, xbin_w: int, tile_rows: int,
                          cull_backfaces: bool = False) -> RasterInputs:
    """Pre-kernel work of the x-binned Gouraud raster (``_rasterize_binned``
    :469-517): every face is copied into each of the ceil(W / xbin_w)
    x-bands, valid in a band when it is valid and its bbox meets
    [k xbin_w, (k + 1) xbin_w); each band is stably y-sorted with its
    invalid copies last and packed; the twin's range table is keyed by
    (image, band, y-tile) with tile_ymax exclusive at (ty + 1) tile_rows.
    For planes on the card, the kernel's own tables of every band
    (``kernel_tables``)."""
    if vert_colors.shape[-1] != 3:
        raise ValueError("the binned raster is Gouraud only and takes (r, g, b) attrs, "
                         f"got {tuple(vert_colors.shape)}")
    F = faces.shape[-2]
    n_chunks = (F + LANE - 1) // LANE
    n_bands = (width + xbin_w - 1) // xbin_w
    n_ytiles = (height + tile_rows - 1) // tile_rows
    sf = build_screen_faces(verts_screen, vert_colors, faces, face_valid,
                            cull_backfaces=cull_backfaces)
    B, dev = sf.valid.shape[0], sf.valid.device
    xlo = torch.arange(n_bands, dtype=torch.float32, device=dev)[None, :, None] * xbin_w
    in_band = ((sf.valid[:, None, :] > 0) & (sf.bbox[:, None, :, 2] >= xlo)
               & (sf.bbox[:, None, :, 0] < xlo + xbin_w)).float()

    def banded(a):  # (B, F, ...) -> (B * NB, F, ...)
        return a[:, None].expand((B, n_bands) + a.shape[1:]).reshape((B * n_bands,) + a.shape[1:])

    sfb = ScreenFace(*(banded(a) for a in sf))._replace(valid=in_band.reshape(B * n_bands, F))
    sfb, order = _sort_faces(sfb)
    geom, col = pack_faces(sfb, n_chunks)
    extents = _chunk_extents(sfb, n_chunks)
    ty = torch.arange(n_ytiles, dtype=torch.float32, device=dev)
    ranges = _ranges_for_rows(extents, ty * tile_rows, (ty + 1) * tile_rows)
    shape = (B, n_bands, n_chunks, N_ROWS, LANE)
    inp = RasterInputs(geom.reshape(shape), col.reshape(shape), order.reshape(B, n_bands, F),
                       height, width, ranges.reshape(B, n_bands, n_ytiles, 2),
                       (xbin_w, tile_rows), extents)
    return kernel_tables(inp) if geom.is_cuda else inp


def _nearest_face_torch(ranges: torch.Tensor, geom: torch.Tensor, height: int, width: int,
                        tile: Tuple[int, ...] = ()):
    """Plain pass 1: the same chunk scan, key packing and tie-break as the
    kernels. Each chunk is evaluated only on the pixels of its tiles'
    ranges inside its box (``chunk_boxes``); outside it no face of the
    chunk can hit, so the keys are those of a scan of every face. ``tile``
    () is the 1-D layout (ranges (B, T, 2), geom (B, NC, 16, 128),
    TILE_PX-pixel tiles); (xbin_w, tile_rows) the binned one (ranges
    (B, NB, YT, 2), geom (B, NB, NC, 16, 128), band k holding the columns
    [k xbin_w, (k + 1) xbin_w) and tile ty the rows [ty tile_rows,
    (ty + 1) tile_rows)). -> (best key, best chunk), each (B, H * W) int32."""
    B = ranges.shape[0]
    dev = geom.device
    if tile:
        xbin_w, tile_rows = tile
    else:
        xbin_w, geom, ranges = width, geom[:, None], ranges[:, None]
    lane = torch.arange(LANE, dtype=torch.int32, device=dev)
    best = torch.zeros((B, height * width), dtype=torch.int32, device=dev)
    best_chunk = torch.zeros_like(best)
    ranges_host = ranges.cpu()
    for k in range(geom.shape[1]):
        boxes = chunk_boxes(face_boxes(geom[:, k])).cpu().tolist()
        band_x0, band_x1 = k * xbin_w, min((k + 1) * xbin_w, width)
        for b in range(B):
            for c in range(geom.shape[2]):
                x0, x1, y0, y1 = boxes[b][c]
                x0, y0 = max(x0, band_x0), max(y0, 0)
                x1, y1 = min(x1, band_x1), min(y1, height)
                if x0 >= x1 or y0 >= y1:
                    continue
                yy, xx = torch.meshgrid(torch.arange(y0, y1, device=dev),
                                        torch.arange(x0, x1, device=dev), indexing="ij")
                pix = (yy * width + xx).reshape(-1)
                t = (torch.div(yy.reshape(-1), tile_rows, rounding_mode="floor") if tile
                     else torch.div(pix, TILE_PX, rounding_mode="floor"))
                r = ranges_host[b, k].to(dev)[t]
                pix = pix[(r[:, 0] <= c) & (c < r[:, 1])]
                g = geom[b, k, c][:, None, :]  # (16, 1, 128)
                for p0 in range(0, pix.numel(), _TWIN_ELEMS // LANE):
                    p = pix[p0:p0 + _TWIN_ELEMS // LANE]
                    x = (p % width).float()[:, None] + 0.5
                    y = torch.div(p, width, rounding_mode="floor").float()[:, None] + 0.5
                    lam0 = x * g[0] + y * g[2] + g[4]
                    lam1 = x * g[1] + y * g[3] + g[5]
                    lam2 = 1.0 - lam0 - lam1
                    w = x * g[6] + y * g[7] + g[8]
                    wbits = w.view(torch.int32)
                    hit = ((lam0 >= _EPS_EDGE) & (lam1 >= _EPS_EDGE) & (lam2 >= _EPS_EDGE)
                           & (wbits > 0))
                    m = torch.where(hit, (wbits & ~_LANE_MASK) | lane, 0).amax(-1)
                    bs = best[b, p]
                    best_chunk[b, p] = torch.where(m > bs, c, best_chunk[b, p])
                    best[b, p] = torch.maximum(bs, m)
    return best, best_chunk


def _winner_planes(ranges, geom, col, height, width, tile: Tuple[int, ...] = ()):
    """Pass 1 plus the gather of each pixel's winning face planes ->
    (x, y, hit mask, depth, win_sorted, planes (B, H*W, 16)); win_sorted
    indexes the faces of the pixel's band (``tile`` as for
    ``_nearest_face_torch``)."""
    B, n_pix = ranges.shape[0], height * width
    best, best_chunk = _nearest_face_torch(ranges, geom, height, width, tile)
    pix = torch.arange(n_pix, device=geom.device)
    x = (pix % width).float() + 0.5
    y = torch.div(pix, width, rounding_mode="floor").float() + 0.5
    hitm = best > 0
    w_rec = torch.clamp_min((best & ~_LANE_MASK).view(torch.float32), 1e-30)
    depth = torch.where(hitm, torch.ones_like(w_rec) / w_rec, 0.0)
    win_sorted = best_chunk * LANE + (best & _LANE_MASK)
    n_faces = geom.shape[-3] * LANE  # padded faces of one band
    band = torch.div(pix % width, tile[0], rounding_mode="floor") if tile else torch.zeros_like(pix)
    planes = col.transpose(-2, -1).reshape(B, -1, N_ROWS)
    idx = band[None] * n_faces + win_sorted.long()
    fc = torch.gather(planes, 1, idx[..., None].expand(B, n_pix, N_ROWS))
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


def _gouraud_pass2(x, y, hitm, depth, fc) -> Tuple[torch.Tensor, torch.Tensor]:
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=fc.device)

    def q8(k):
        c = x * fc[..., k] + y * fc[..., k + 3] + fc[..., k + 6]
        return torch.floor(torch.clamp(c * depth, 0.0, 1.0) * 255.0 + 0.5)

    rgb = torch.stack([q8(0), q8(1), q8(2)], dim=-1) * inv255
    return torch.where(hitm[..., None], rgb, torch.zeros_like(rgb)), depth


def rasterize_batch_rgb_torch(ranges: torch.Tensor, geom: torch.Tensor, col: torch.Tensor,
                              height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the Gouraud kernel: -> (rgb (B, H*W, 3) in
    {k * float32(1/255)}, depth (B, H*W))."""
    x, y, hitm, depth, _, fc = _winner_planes(ranges, geom, col, height, width)
    return _gouraud_pass2(x, y, hitm, depth, fc)


def rasterize_batch_rgb_binned_torch(ranges: torch.Tensor, geom: torch.Tensor,
                                     col: torch.Tensor, height: int, width: int, xbin_w: int,
                                     tile_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the x-binned Gouraud kernel on the inputs of
    ``prepare_raster_binned``: -> (rgb (B, H*W, 3), depth (B, H*W)), the
    pixels outside the image cropped."""
    x, y, hitm, depth, _, fc = _winner_planes(ranges, geom, col, height, width,
                                              (xbin_w, tile_rows))
    return _gouraud_pass2(x, y, hitm, depth, fc)


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
            lib.raster_uv_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                             + [ctypes.c_void_p])
            lib.raster_uv_launch.restype = ctypes.c_int
            lib.raster_rgb_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                              + [ctypes.c_void_p])
            lib.raster_rgb_launch.restype = ctypes.c_int
            lib.raster_rgb_binned_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                                     + [ctypes.c_void_p])
            lib.raster_rgb_binned_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def _check_inputs(name: str, ranges, geom, col, height: int, width: int,
                  tile: Tuple[int, int]):
    """What the binned kernel's wrapper refuses before a launch, ``tile`` =
    (xbin_w, tile_rows) (``prepare_raster_binned``)."""
    if ranges.dim() != 4 or geom.dim() != 5:
        raise ValueError(f"{name}: ranges (B, NB, YT, 2) and geom/col with one more axis")
    expect = tuple(ranges.shape[:-2]) + (geom.shape[-3], N_ROWS, LANE)
    if (ranges.shape[-1] != 2 or tuple(geom.shape) != expect or tuple(col.shape) != expect
            or ranges.dtype != torch.int32 or geom.dtype != torch.float32
            or col.dtype != torch.float32
            or not all(t.is_contiguous() and t.device == geom.device
                       for t in (ranges, geom, col))):
        raise ValueError(f"{name}: ranges (B, NB, YT, 2) int32 and geom/col {expect} "
                         "float32, contiguous, on one CUDA device")
    xbin_w, tile_rows = tile
    if (xbin_w < 1 or tile_rows < 1 or ranges.shape[1] != -(-width // xbin_w)
            or ranges.shape[2] != -(-height // tile_rows)):
        raise ValueError(f"{name}: ranges {tuple(ranges.shape)} do not tile a "
                         f"{height}x{width} image in {tile_rows}x{xbin_w} tiles")


def _check_tables(name: str, inp: RasterInputs):
    """What every kernel wrapper refuses before a launch: planes and tables
    other than ``prepare_raster``'s or ``prepare_raster_binned``'s on the
    card (the binned ones with a band axis after the batch axis)."""
    lead, NC = tuple(inp.geom.shape[:-3]), inp.geom.shape[-3]
    want = ((inp.geom, lead + (NC, N_ROWS, LANE), torch.float32),
            (inp.col, lead + (NC, N_ROWS, LANE), torch.float32),
            (inp.tiles, lead + (-(-inp.height // RASTER_TILE), 2), torch.int32),
            (inp.chunk_box, lead + (NC, 4), torch.int32),
            (inp.face_box, lead + (NC, LANE, 4), torch.int32))
    for t, shape, dtype in want:
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != inp.geom.device or t.data_ptr() % 16):
            raise ValueError(f"{name}: geom and col (B, [NB,] NC, 16, 128) float32 and the tile "
                             f"tables int32 (.., TY, 2), (.., NC, 4) and (.., NC, {LANE}, 4) = "
                             f"{[s for _, s, _ in want]}, contiguous and 16-byte aligned "
                             "on one CUDA device (``kernel_tables``)")


class RasterKernel:
    """ctypes wrapper of one launch function of ``raster.cu``, called on a
    ``RasterInputs``; ``launches`` counts kernel launches (and nothing
    else). ``twin`` is the plain PyTorch version, called on
    ``RasterInputs.twin_args()``, that the wrapper runs for CPU tensors.
    The binned kernel takes ``prepare_raster_binned``'s inputs, the uv and
    Gouraud kernels ``prepare_raster``'s, each with the kernels' tables."""

    def __init__(self, name: str, library: RasterLibrary, twin):
        self.name, self.library, self.twin = name, library, twin
        self.launches = 0

    @property
    def build_log(self) -> str:
        return self.library.build_log

    def build(self):
        return self.library.get()

    def __call__(self, inp: RasterInputs) -> Tuple[torch.Tensor, ...]:
        binned = self.name == "raster_rgb_binned"
        if bool(inp.tile) != binned:
            raise ValueError(f"{self.name}: got inputs with tile {inp.tile}; only "
                             "raster_rgb_binned takes prepare_raster_binned's (xbin_w, tile_rows)")
        geom, col = inp.geom, inp.col
        if geom.device.type == "cpu":
            return self.twin(*inp.twin_args())
        if geom.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {geom.device}")
        if binned:
            _check_inputs(self.name, inp.ranges, geom, col, inp.height, inp.width, inp.tile)
        _check_tables(self.name, inp)
        lib = self.build()
        B, n_pix = geom.shape[0], inp.height * inp.width
        f32 = dict(dtype=torch.float32, device=geom.device)
        stream = torch.cuda.current_stream(geom.device).cuda_stream
        ptrs = lambda *ts: tuple(t.data_ptr() for t in ts)  # noqa: E731
        tables = ptrs(inp.tiles, inp.chunk_box, inp.face_box)
        with trace("raster/kernel"):
            if self.name == "raster_uv":
                quv, qsp, depth = (torch.empty((B, n_pix), **f32) for _ in range(3))
                win = torch.empty((B, n_pix), dtype=torch.int32, device=geom.device)
                err = lib.raster_uv_launch(*tables, *ptrs(geom, col, quv, qsp, win, depth), B,
                                           geom.shape[1], inp.height, inp.width, stream)
                out = (quv, qsp, win, depth)
            else:
                rgb = torch.empty((B, n_pix, 3), **f32)
                depth = torch.empty((B, n_pix), **f32)
                if self.name == "raster_rgb":
                    err = lib.raster_rgb_launch(*tables, *ptrs(geom, col, rgb, depth), B,
                                                geom.shape[1], inp.height, inp.width, stream)
                else:
                    err = lib.raster_rgb_binned_launch(*tables, *ptrs(geom, col, rgb, depth), B,
                                                       geom.shape[1], geom.shape[2], inp.height,
                                                       inp.width, inp.tile[0], stream)
                out = (rgb, depth)
            if err != 0:
                raise RuntimeError(f"{self.name}_launch failed: CUDA error {err}")
        self.launches += 1
        return out


_library = RasterLibrary()
raster_uv = RasterKernel("raster_uv", _library, rasterize_batch_uv_torch)
raster_rgb = RasterKernel("raster_rgb", _library, rasterize_batch_rgb_torch)
raster_rgb_binned = RasterKernel("raster_rgb_binned", _library,
                                 rasterize_batch_rgb_binned_torch)


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
    return finish_uv_raster(inp, *raster_uv(inp))


def rasterize_batch_rgb(verts_screen: torch.Tensor, vert_colors: torch.Tensor,
                        faces: torch.Tensor, face_valid: Optional[torch.Tensor],
                        height: int, width: int, cull_backfaces: bool = False,
                        xbin_w: Optional[int] = None, tile_rows: int = 8):
    """Gouraud raster -> (rgb (B, H, W, 3) 8-bit quantised, depth (B, H, W),
    0 = background). With ``xbin_w`` set and the image wider than one band,
    the x-binned kernel in tile_rows x xbin_w tiles, as
    ``rasterize_batch_pallas`` chooses (:344-347); else the 1-D kernel."""
    if xbin_w is not None and width > xbin_w:
        inp = prepare_raster_binned(verts_screen, vert_colors, faces, face_valid, height,
                                    width, xbin_w, tile_rows, cull_backfaces)
        return finish_rgb_raster(inp, *raster_rgb_binned(inp))
    inp = prepare_raster(verts_screen, vert_colors, faces, face_valid, height, width,
                         cull_backfaces)
    return finish_rgb_raster(inp, *raster_rgb(inp))
