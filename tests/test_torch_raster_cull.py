"""The culling of the uv and Gouraud raster kernels (B1, B2) on the CPU: the
per-face boxes, the 16 x 16 tiles' tables and a plain rehearsal of the
kernels' schedule (``artiboost_torch/ops/rasterizer_cuda.py``), and what
their measurements count (``artiboost_torch/ops/raster_measure.py``).

  (a) every (pixel, face) pair that a scan of every face hits (the kernels'
      plane test, rounded as they round it) lies in that face's
      ``face_boxes`` box, and in its chunk's ``chunk_boxes`` box;
  (b) for every tile, the faces its tables let each warp scan for its
      8 x 8 region (``scanned_faces``) hold every face that hits a pixel of
      the region;
  (c) a rehearsal of the kernel's schedule: per tile, the faces of the
      chunks in its row's range that pass the chunk and face box tests, in
      (chunk, lane) order; per region, those of them whose box meets it,
      scanned with strict > on the depth key. They give the twins' winners,
      and the twins' outputs from those winners are bit-equal to
      ``rasterize_batch_uv_torch`` and ``rasterize_batch_rgb_torch``;
  (d) ``raster_work`` (bytes read and written, pixel x face-box pairs) on a
      scene counted by hand, and ``sass_counts`` on a listing read by hand.
Scenes: those of ``artiboost_torch/ops/raster_scenes.py`` (F = 60 and
700, invalid faces, the depth tie; back-face culling off and on) and two
SyntheticHO images at 128x128. The kernels themselves run only on a card:
``chip_smoke.py`` holds them bit for bit against the twins."""
from functools import lru_cache

import pytest
import torch

from artiboost_torch.ops import rasterizer_cuda as rc
from artiboost_torch.ops.raster_measure import raster_work, sass_counts, scanned_faces
from artiboost_torch.ops.raster_scenes import raster_check_scenes, rgb_attrs

SYNTH = {"TYPE": "SyntheticHO", "DATA_SPLIT": "train", "AUG": True, "N_SAMPLES": 2,
         "RAW_SIZE": 128, "AUG_PARAM": {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}}
PRESET = {"BBOX_EXPAND_RATIO": 1.2, "IMAGE_SIZE": [64, 64], "CENTER_IDX": 0,
          "CROP_MODEL": "root_obj", "FULL_IMAGE": False}
SCENES = [f"{name}_cull{int(cull)}" for name in raster_check_scenes()
          for cull in (False, True)] + ["synthetic_ho"]


@lru_cache(maxsize=None)
def _raster_args(scene: str):
    """-> (args of ``prepare_raster`` with (u, v, shade, page) attrs or None,
    args with (r, g, b) attrs, kwargs)."""
    if scene == "synthetic_ho":
        from artiboost_torch.artiboost import renderer
        from artiboost_torch.datasets.synthetic import SyntheticHO

        seen, orig = {}, renderer.rasterize_batch_rgb

        def spy(*a, **k):
            seen.setdefault("call", (a, k))
            return orig(*a, **k)

        renderer.rasterize_batch_rgb = spy
        try:
            SyntheticHO(DATA_PRESET=PRESET, device="cpu", **SYNTH)
        finally:
            renderer.rasterize_batch_rgb = orig
        args, kw = seen["call"]
        return None, tuple(args), dict(kw)
    name, cull = scene.rsplit("_cull", 1)
    sc = raster_check_scenes()[name]
    t = [torch.from_numpy(sc[k]) for k in ("verts", "attrs", "faces", "valid")]
    rest = (sc["H"], sc["W"])
    return ((t[0], t[1], t[2], t[3]) + rest, (t[0], torch.from_numpy(rgb_attrs(sc)), t[2], t[3])
            + rest, {"cull_backfaces": cull == "1"})


def _inputs(scene: str, rgb: bool = True) -> rc.RasterInputs:
    """``prepare_raster``'s inputs with the kernels' tables, which it builds
    only for planes on the card."""
    uv_args, rgb_args, kw = _raster_args(scene)
    return rc.kernel_tables(rc.prepare_raster(*(rgb_args if rgb else uv_args), **kw))


def _pixels(height: int, width: int):
    pix = torch.arange(height * width)
    return (pix % width).float() + 0.5, torch.div(pix, width, rounding_mode="floor").float() + 0.5


@lru_cache(maxsize=None)
def _full_hits(scene: str):
    """Every face at every pixel, with the kernels' plane test and key
    rounding: -> list over chunks of (chunk, hits (B, H*W, 128) bool) for
    the chunks that hold a valid face."""
    inp = _inputs(scene)
    x, y = _pixels(inp.height, inp.width)
    x, y = x[:, None], y[:, None]
    out = []
    for c in range(inp.geom.shape[1]):
        g = inp.geom[:, c][:, :, None, :]  # (B, 16, 1, 128)
        if not bool((g[:, 4] > -1e29).any()):
            continue
        lam0 = x * g[:, 0] + y * g[:, 2] + g[:, 4]
        lam1 = x * g[:, 1] + y * g[:, 3] + g[:, 5]
        lam2 = 1.0 - lam0 - lam1
        wbits = (x * g[:, 6] + y * g[:, 7] + g[:, 8]).view(torch.int32)
        out.append((c, (lam0 >= -1e-6) & (lam1 >= -1e-6) & (lam2 >= -1e-6) & (wbits > 0)))
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_face_boxes_hold_every_hit(scene):
    inp = _inputs(scene)
    x, y = _pixels(inp.height, inp.width)
    n_hits = 0

    def inside(box):  # (..., 4) boxes -> (B, H*W, ...) pixels in them
        box = box.float()
        return ((x[:, None] >= box[..., 0]) & (x[:, None] < box[..., 1])
                & (y[:, None] >= box[..., 2]) & (y[:, None] < box[..., 3]))

    for c, hits in _full_hits(scene):
        in_face = inside(inp.face_box[:, c][:, None])  # (B, H*W, 128)
        assert not bool((hits & ~in_face).any()), f"chunk {c}: a hit outside its face's box"
        in_chunk = inside(inp.chunk_box[:, c][:, None, None])[..., 0]  # (B, H*W)
        assert not bool((hits.any(-1) & ~in_chunk).any()), f"chunk {c}: a hit outside its box"
        n_hits += int(hits.sum())
    assert (n_hits > 0) != (scene == "tie_cull1")  # both tie triangles are back faces
    # invalid and padded faces have empty boxes
    fb = inp.face_box
    empty = inp.geom[:, :, 4] <= -1e29
    lim = rc.BOX_LIMIT
    assert bool((fb[empty] == torch.tensor([lim, -lim, lim, -lim], dtype=torch.int32)).all())


T = rc.RASTER_TILE


def _tile_grid(inp):
    return -(-inp.height // T), -(-inp.width // T)


def _region_hits(scene: str, inp) -> torch.Tensor:
    """(B, RY, RX, NC, 128) bool: the faces that hit a pixel of each 8 x 8
    region of the tile grid."""
    ty, tx = _tile_grid(inp)
    r = rc.RASTER_REGION
    B, NC = inp.geom.shape[:2]
    ry, rx = ty * T // r, tx * T // r
    out = torch.zeros((B, ry, rx, NC, rc.LANE), dtype=torch.bool)
    for c, hits in _full_hits(scene):
        h = hits.reshape(B, inp.height, inp.width, rc.LANE)
        h = torch.nn.functional.pad(h, (0, 0, 0, rx * r - inp.width, 0, ry * r - inp.height))
        out[:, :, :, c] = h.reshape(B, ry, r, rx, r, rc.LANE).any(4).any(2)
    return out


def _meets_regions(box, x0: int, y0: int) -> torch.Tensor:
    """(n, 4) face boxes -> (n, regions) bool: the 8 x 8 regions of the tile
    at (x0, y0) that each box meets, in the kernel's warp order (row-major)."""
    r = rc.RASTER_REGION
    qx = x0 + torch.arange(T // r).repeat(T // r) * r
    qy = y0 + torch.arange(T // r).repeat_interleave(T // r) * r
    return ((box[:, None, 0] < qx + r) & (box[:, None, 1] > qx) & (box[:, None, 2] < qy + r)
            & (box[:, None, 3] > qy))


def _rehearsal_lists(inp):
    """The kernel's staging, tile by tile: -> ((B, TY, TX) index of each
    tile, list of flat face ids chunk * 128 + lane in (chunk, lane) order)."""
    ty_n, tx_n = _tile_grid(inp)
    lists = []
    for b in range(inp.geom.shape[0]):
        for ty in range(ty_n):
            c0, c1 = inp.tiles[b, ty].tolist()
            for tx in range(tx_n):
                x0, y0 = tx * T, ty * T
                ids = []
                for c in range(c0, c1):
                    cb = inp.chunk_box[b, c].tolist()
                    if not (cb[0] < x0 + T and cb[1] > x0 and cb[2] < y0 + T and cb[3] > y0):
                        continue
                    fb = inp.face_box[b, c]
                    keep = ((fb[:, 0] < x0 + T) & (fb[:, 1] > x0) & (fb[:, 2] < y0 + T)
                            & (fb[:, 3] > y0))
                    ids.append(c * rc.LANE + torch.nonzero(keep)[:, 0])
                empty = torch.zeros(0, dtype=torch.long)
                lists.append(((b, ty, tx), torch.cat(ids) if ids else empty))
    return lists


def _region_lists(inp, lists):
    """-> (T, L, regions) bool: for each tile's staged face, the 8 x 8
    regions (warps) of the tile that scan it."""
    n_max = max(max(len(ids) for _, ids in lists), 1)
    out = torch.zeros((len(lists), n_max, (T // 8) ** 2), dtype=torch.bool)
    boxes = inp.face_box.reshape(inp.geom.shape[0], -1, 4)
    for i, ((b, ty, tx), ids) in enumerate(lists):
        out[i, :len(ids)] = _meets_regions(boxes[b, ids], tx * T, ty * T)
    return out


def _rehearse(inp):
    """The kernel's pass 1 as it schedules it: every tile stages its faces in
    order, and each 8 x 8 region scans those whose box meets it, each pixel
    keeping the key with strict >. -> (best key, best chunk), each
    (B, H * W) int32, as ``_nearest_face_torch``; and the tiles' lists."""
    B, n_pix = inp.geom.shape[0], inp.height * inp.width
    lists = _rehearsal_lists(inp)
    scans = _region_lists(inp, lists)  # (T, L, regions)
    ids = torch.full(scans.shape[:2], -1, dtype=torch.long)
    for i, (_, f) in enumerate(lists):
        ids[i, :len(f)] = f
    b = torch.tensor([t[0] for t, _ in lists])
    i = torch.arange(T * T)
    r = rc.RASTER_REGION
    region = (i // T) // r * (T // r) + (i % T) // r  # the pixel's warp, row-major
    py = torch.tensor([t[1] for t, _ in lists])[:, None] * T + i // T
    px = torch.tensor([t[2] for t, _ in lists])[:, None] * T + i % T
    x, y = px.float() + 0.5, py.float() + 0.5
    planes = inp.geom.transpose(2, 3).reshape(B, -1, rc.N_ROWS)  # (B, NC * 128, 16)
    best = torch.zeros_like(x, dtype=torch.int32)
    best_chunk = torch.zeros_like(best)
    for e in range(ids.shape[1]):
        f = ids[:, e]
        g = planes[b, f.clamp_min(0)][:, :, None]  # (T, 16, 1)
        lam0 = x * g[:, 0] + y * g[:, 2] + g[:, 4]
        lam1 = x * g[:, 1] + y * g[:, 3] + g[:, 5]
        lam2 = 1.0 - lam0 - lam1
        wbits = (x * g[:, 6] + y * g[:, 7] + g[:, 8]).view(torch.int32)
        hit = ((lam0 >= -1e-6) & (lam1 >= -1e-6) & (lam2 >= -1e-6) & (wbits > 0)
               & scans[:, e][:, region])
        key = (wbits & ~0x7F) | (f % rc.LANE).int()[:, None]
        win = hit & (key > best)
        best = torch.where(win, key, best)
        best_chunk = torch.where(win, torch.div(f, rc.LANE, rounding_mode="floor").int()[:, None],
                                 best_chunk)
    inside = (px < inp.width) & (py < inp.height)
    out_key = torch.zeros((B, n_pix), dtype=torch.int32)
    out_chunk = torch.zeros_like(out_key)
    flat = (py * inp.width + px)[inside]
    out_key[b[:, None].expand_as(px)[inside], flat] = best[inside]
    out_chunk[b[:, None].expand_as(px)[inside], flat] = best_chunk[inside]
    return out_key, out_chunk, lists


@pytest.mark.parametrize("scene", SCENES)
def test_tile_tables_hold_every_hit(scene):
    inp = _inputs(scene)
    scanned = scanned_faces(inp)
    hits = _region_hits(scene, inp)
    assert not bool((hits & ~scanned).any()), "a face hits a region whose warp does not scan it"
    assert int(hits.sum()) <= int(scanned.sum())
    # the rule the rehearsal stages and scans by is the one scanned_faces counts
    lists = _rehearsal_lists(inp)
    scans = _region_lists(inp, lists)
    r = rc.RASTER_REGION
    for (i, ((b, ty, tx), ids)) in enumerate(lists):
        for q in range(scans.shape[2]):
            ry, rx = ty * T // r + q // (T // r), tx * T // r + q % (T // r)
            want = torch.zeros(inp.geom.shape[1] * rc.LANE, dtype=torch.bool)
            want[ids[scans[i, :len(ids), q]]] = True
            assert torch.equal(scanned[b, ry, rx].reshape(-1), want), (b, ry, rx)


@lru_cache(maxsize=None)
def _twin_outputs(scene: str):
    """-> (the twins' pass-1 winners (key, chunk), [(twin, its outputs)]): the
    Gouraud twin, and the uv twin on the seeded scenes."""
    seen, orig = {}, rc._nearest_face_torch

    def spy(*a, **k):
        seen["winners"] = orig(*a, **k)
        return seen["winners"]

    rc._nearest_face_torch = spy
    try:
        inp = _inputs(scene)
        out = [(rc.rasterize_batch_rgb_torch, rc.rasterize_batch_rgb_torch(*inp.twin_args()))]
        winners = seen["winners"]
        if scene != "synthetic_ho":
            uv = _inputs(scene, rgb=False).twin_args()
            out.append((rc.rasterize_batch_uv_torch, rc.rasterize_batch_uv_torch(*uv)))
    finally:
        rc._nearest_face_torch = orig
    return winners, out


@pytest.mark.parametrize("scene", SCENES)
def test_rehearsed_schedule_bit_equal_to_twins(scene, monkeypatch):
    inp = _inputs(scene)
    key, chunk, lists = _rehearse(inp)
    (want_key, want_chunk), twins = _twin_outputs(scene)
    assert torch.equal(key, want_key) and torch.equal(chunk, want_chunk)
    assert bool((key > 0).any()) != (scene == "tie_cull1")
    # the twins' outputs from the rehearsed winners
    monkeypatch.setattr(rc, "_nearest_face_torch", lambda *a, **k: (key, chunk))
    for twin, ref in twins:
        i = inp if twin is rc.rasterize_batch_rgb_torch else _inputs(scene, rgb=False)
        for a, r in zip(twin(*i.twin_args()), ref):
            assert torch.equal(a, r), twin.__name__
    # the 128-face list is refilled where a tile stages more: the large random scenes
    if scene.startswith(("multi", "invalid")):
        assert max(len(ids) for _, ids in lists) > 128


def test_raster_work_counted_by_hand():
    """One image of 16 x 24 pixels, three faces: A with vertices (10.5, 4.5),
    (13.5, 4.5), (10.5, 7.5), so the box [8, 16) x [2, 10) of 64 pixels; B at
    (20.5, 12.5), (23.5, 12.5), (20.5, 15.5), box [18, 26) x [10, 18), of
    which [18, 24) x [10, 16) = 36 pixels lie in the image; C invalid."""
    verts = torch.tensor([[[10.5, 4.5, 1.0], [13.5, 4.5, 1.0], [10.5, 7.5, 1.0],
                           [20.5, 12.5, 1.0], [23.5, 12.5, 1.0], [20.5, 15.5, 1.0]]])
    faces = torch.tensor([[0, 1, 2], [3, 4, 5], [0, 2, 4]])
    valid = torch.tensor([[1.0, 1.0, 0.0]])
    rgb = torch.full((1, 6, 3), 0.5)
    inp = rc.kernel_tables(rc.prepare_raster(verts, rgb, faces, valid, 16, 24))
    lim = rc.BOX_LIMIT
    assert inp.face_box[0, 0, :3].tolist() == [[8, 16, 2, 10], [18, 26, 10, 18],
                                                 [lim, -lim, lim, -lim]]
    assert inp.chunk_box[0, 0].tolist() == [8, 26, 2, 18]
    assert inp.tiles.tolist() == [[[0, 1]]]  # one row of 16 x 16 tiles, one chunk
    # read: 2 valid faces x (9 geometry rows + 9 r, g, b rows, or 12 u, v, shade,
    # page rows) x 4 B, and the twins' 1-D range table, ceil(384 / 256) = 2 tiles
    # x 2 int32; no padded lane, no kernel table; written: 16 B for each of 384 pixels
    assert raster_work(inp, 3) == (2 * 18 * 4 + 2 * 2 * 4, 16 * 384, 64 + 36)
    assert raster_work(inp, 4) == (2 * 21 * 4 + 2 * 2 * 4, 16 * 384, 64 + 36)
    # the binned layout at 8-pixel bands and 8-row tiles: A valid in band 1 only, B in
    # band 2 only; its range table is 3 bands x 2 y-tiles x 2 int32
    binp = rc.prepare_raster_binned(verts, rgb, faces, valid, 16, 24, 8, 8)
    assert raster_work(binp, 3) == (2 * 18 * 4 + 3 * 2 * 2 * 4, 16 * 384, 64 + 36)


def test_sass_counts_read_by_hand():
    """A listing in ``cuobjdump -sass``'s form: two loops; the smaller one
    with float work is the inner one, 5 instructions from 0x0030 to 0x0070."""
    listing = """
        Function : _ZN12_GLOBAL__N_116raster_uv_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E [R2], desc[UR4][R4.64] ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDS.128 R8, [R3] ;
        /*0040*/                   FMUL R9, R9, R10 ;
        /*0050*/                   FADD R9, R9, R11 ;
        /*0060*/                   ISETP.NE.AND P0, PT, R3, R4, PT ;
        /*0070*/               @P0 BRA 0x30 ;
        /*0080*/                   LDS R12, [R3+0x4] ;
        /*0090*/                   FFMA R9, R9, R10, R11 ;
        /*00a0*/              @!P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_124raster_rgb_binned_kernelILi2EEEvv
        /*0000*/                   FADD R1, R1, R2 ;
        /*0010*/                   EXIT ;
    """
    got = sass_counts(listing)
    uv = got["_ZN12_GLOBAL__N_116raster_uv_kernelEv"]
    assert uv["loop_len"] == 5
    assert uv["loop"] == {"LDS.128": 1, "FMUL": 1, "FADD": 1, "ISETP": 1, "BRA": 1}
    assert uv["all"]["LDS.128"] == 1 and uv["all"]["LDS"] == 1 and uv["all"]["FFMA"] == 1
    assert uv["all"]["LDGSTS"] == 1 and uv["all"]["BAR"] == 1 and sum(uv["all"].values()) == 12
    binned = got["_ZN12_GLOBAL__N_124raster_rgb_binned_kernelILi2EEEvv"]
    assert binned["loop_len"] == 0 and binned["all"] == {"FADD": 1, "EXIT": 1}


def test_tile_table_checks():
    """Which tables ``prepare_raster`` builds, and what the uv and Gouraud
    wrappers refuse in their tables."""
    _, rgb_args, kw = _raster_args("small_cull0")
    cpu = rc.prepare_raster(*rgb_args, **kw)  # planes on the CPU: a twin runs, no kernel table
    assert cpu.tiles is None and cpu.chunk_box is None and cpu.face_box is None
    assert cpu.ranges is None and cpu.tile == () and cpu.extents is not None
    inp = rc.kernel_tables(cpu)
    rc._check_tables("b2", inp)
    with pytest.raises(ValueError, match="tile tables"):
        rc._check_tables("b2", cpu)
    with pytest.raises(ValueError, match="tile tables"):
        rc._check_tables("b2", inp._replace(tiles=inp.tiles.long()))
    rows8 = torch.arange(float(-(-inp.height // 8))) * 8
    assert rows8.numel() != inp.tiles.shape[1]
    with pytest.raises(ValueError, match="tile tables"):  # a table of 8-row tiles
        rc._check_tables("b2", inp._replace(tiles=rc._ranges_for_rows(inp.extents, rows8,
                                                                      rows8 + 8)))
    # on the CPU the wrapper runs the twin on the 1-D table it builds, tables or none
    want = rc.rasterize_batch_rgb_torch(*inp.twin_args())
    sf, _ = rc._sort_faces(rc.build_screen_faces(*rgb_args[:4], **kw))
    n_tiles = -(-inp.height * inp.width // rc.TILE_PX)
    assert torch.equal(inp.twin_args()[0],
                       rc.chunk_ranges(sf, inp.geom.shape[1], n_tiles, inp.width))
    for given in (cpu, inp):
        rgb, depth = rc.raster_rgb(given)
        assert torch.equal(rgb, want[0]) and torch.equal(depth, want[1])
