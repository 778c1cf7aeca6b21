"""The culling of the x-binned Gouraud raster kernel (B3) on the CPU: its
tables, built per band by ``kernel_tables``, and a plain rehearsal of its
schedule (``artiboost_torch/ops/rasterizer_cuda.py``), what its
measurements count (``artiboost_torch/ops/raster_measure.py``), and the
binned twin at a tile of more than 2048 pixels against the JAX package.

  (a) every (pixel, face) pair that a scan of every face of a band hits (the
      kernel's plane test, rounded as it rounds it) lies in that band copy's
      ``face_boxes`` box, and in its chunk's ``chunk_boxes`` box;
  (b) every hit at a pixel of a band's columns is in its row of 16 x 16
      windows' chunk range (``tile_ranges`` on the band's chunks), and the
      faces the tables let each warp scan for its 8 x 8 region
      (``scanned_faces``) hold every face that hits a pixel the region
      writes;
  (c) a rehearsal of the kernel's schedule: per 16 x 16 window of a band
      (the band's windows start at its left edge), the faces of the chunks
      in its row's range that pass the chunk and face box tests, in (chunk,
      lane) order; per 8 x 8 region, those of them whose box meets it,
      scanned with strict > on the depth key (the lane in the band's
      chunks). The winners at the pixels of the band's columns are the
      binned twin's, and the twin's outputs from them are bit-equal to
      ``rasterize_batch_rgb_binned_torch``;
  (d) ``face_evaluations`` and ``region_columns`` on a scene counted by hand;
  (e) the binned twin at a (128, 32) tile, 4096 pixels, is bit-equal to
      ``rasterize_batch_pallas(xbin_w=128, tile_rows=32)`` in Pallas
      interpret mode, run as in ``tests/test_torch_raster_binned.py``: in a
      subprocess with ``--xla_cpu_max_isa=AVX``, where XLA rounds a*b+c
      twice as the kernel and its twin do.
Cases: those of ``tests/test_torch_raster_binned.py`` (random scenes at
(xbin_w, tile_rows) = (16, 8), (8, 4) and (16, 5), the seeded scenes with
culling off and on, and the 8 x 4 tile on the 700-face scene). The kernel
itself runs only on a card: ``chip_smoke.py`` holds it bit for bit against
the twin."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from artiboost_torch.ops import rasterizer_cuda as rc
from artiboost_torch.ops.raster_measure import face_evaluations, region_columns, scanned_faces
from artiboost_torch.ops.raster_scenes import random_scene, rgb_attrs
from tests.test_torch_raster_binned import _JAX_REFERENCE, CASES, CASES_1D, NO_FMA_ENV

T = rc.RASTER_TILE
R = rc.RASTER_REGION
# a tile of 32 x 128 = 4096 pixels on a 64 x 256 frame of 500 faces
BIG = dict(random_scene(np.random.RandomState(9), 1, 300, 500, 64, 256), cull=False, xbin_w=128,
           tile_rows=32)
BIG["rgb"] = rgb_attrs(BIG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per process while this file runs, as in the other
    raster test files: the suite's workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_run(tmp_path_factory):
    """Starts the JAX binned raster on ``BIG`` as the file starts, so that it
    runs beside the file's other tests; ``jax_big`` waits for it."""
    d = tmp_path_factory.mktemp("raster_binned_big")
    arrays = {f"big/{k}": BIG[k] for k in ("verts", "rgb", "faces", "valid")}
    arrays["big/shape"] = np.array([BIG["H"], BIG["W"], BIG["cull"], BIG["xbin_w"],
                                    BIG["tile_rows"]])
    np.savez(d / "cases.npz", **arrays)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **NO_FMA_ENV,
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    with open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", _JAX_REFERENCE, str(d / "cases.npz"),
                                 str(d / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
                                stderr=err)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_big(_jax_reference_run):
    proc, d = _jax_reference_run
    assert proc.wait(timeout=600) == 0, (d / "stderr.txt").read_text()[-4000:]
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def _inputs(c) -> rc.RasterInputs:
    """``prepare_raster_binned``'s inputs with the kernel's tables, which it
    builds only for planes on the card."""
    args = [torch.from_numpy(c[k]) for k in ("verts", "rgb", "faces", "valid")]
    return rc.kernel_tables(rc.prepare_raster_binned(
        *args, c["H"], c["W"], c["xbin_w"], c["tile_rows"], cull_backfaces=c["cull"]))


def _pixels(height: int, width: int):
    pix = torch.arange(height * width)
    return (pix % width).float() + 0.5, torch.div(pix, width, rounding_mode="floor").float() + 0.5


def _band_hits(inp):
    """Every face of every band at every pixel of the image, with the
    kernel's plane test and rounding: -> (B, NB, NC, H*W, 128) bool."""
    x, y = _pixels(inp.height, inp.width)
    x, y = x[:, None], y[:, None]
    g = inp.geom[..., None, :]  # (B, NB, NC, 16, 1, 128)
    lam0 = x * g[..., 0, :, :] + y * g[..., 2, :, :] + g[..., 4, :, :]
    lam1 = x * g[..., 1, :, :] + y * g[..., 3, :, :] + g[..., 5, :, :]
    lam2 = 1.0 - lam0 - lam1
    wbits = (x * g[..., 6, :, :] + y * g[..., 7, :, :] + g[..., 8, :, :]).view(torch.int32)
    return (lam0 >= -1e-6) & (lam1 >= -1e-6) & (lam2 >= -1e-6) & (wbits > 0)


def _in_band(inp) -> torch.Tensor:
    """(NB, H*W) bool: the pixels of each band's columns."""
    xbin_w = inp.tile[0]
    col = torch.arange(inp.height * inp.width) % inp.width
    return torch.div(col, xbin_w, rounding_mode="floor")[None] == torch.arange(
        inp.geom.shape[1])[:, None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_band_face_boxes_hold_every_hit(name):
    inp = _inputs(CASES[name])
    hits = _band_hits(inp)
    x, y = _pixels(inp.height, inp.width)

    def inside(box):  # (..., 4) boxes -> (..., H*W) pixels in them
        box = box.float()[..., None, :]
        return (x >= box[..., 0]) & (x < box[..., 1]) & (y >= box[..., 2]) & (y < box[..., 3])

    in_face = inside(inp.face_box).transpose(-1, -2)  # (B, NB, NC, H*W, 128)
    assert not bool((hits & ~in_face).any()), "a hit outside its band copy's box"
    in_chunk = inside(inp.chunk_box)  # (B, NB, NC, H*W)
    assert not bool((hits.any(-1) & ~in_chunk).any()), "a hit outside its chunk's box"
    assert bool(hits.any()) != name.startswith("tie_cull1")  # both tie triangles are back faces
    # a copy outside its band is invalid, with the empty box
    lim = rc.BOX_LIMIT
    empty = inp.geom[..., 4, :] <= -1e29
    assert bool((inp.face_box[empty] == torch.tensor([lim, -lim, lim, -lim],
                                                     dtype=torch.int32)).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_band_window_ranges_hold_every_hit(name):
    inp = _inputs(CASES[name])
    B, NB, NC = inp.geom.shape[:3]
    hits = _band_hits(inp).any(-1) & _in_band(inp)[None, :, None]  # (B, NB, NC, H*W)
    row = torch.div(torch.arange(inp.height * inp.width), inp.width, rounding_mode="floor")
    rng = inp.tiles[:, :, torch.div(row, T, rounding_mode="floor")]  # (B, NB, H*W, 2)
    c = torch.arange(NC)[:, None]
    in_range = (c >= rng[:, :, None, :, 0]) & (c < rng[:, :, None, :, 1])  # (B, NB, NC, H*W)
    assert not bool((hits & ~in_range).any()), "a hit outside its window row's chunk range"
    assert inp.tiles.shape == (B, NB, -(-inp.height // T), 2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_band_regions_scan_every_hit(name):
    inp = _inputs(CASES[name])
    B, NB, NC = inp.geom.shape[:3]
    scanned = scanned_faces(inp)  # (B * NB, RY, RX, NC, 128)
    x0, cols = region_columns(inp)  # (NB, RX)
    hits = _band_hits(inp) & _in_band(inp)[None, :, None, :, None]
    hits = hits.reshape(B * NB, NC, inp.height, inp.width, rc.LANE)
    ry = scanned.shape[1]
    for k in range(NB):
        for i, (xa, n) in enumerate(zip(x0[k].tolist(), cols[k].tolist())):
            if n == 0:
                continue
            for r in range(ry):
                h = hits[k::NB, :, r * R:(r + 1) * R, xa:xa + n].any(2).any(2)  # (B, NC, 128)
                s = scanned[k::NB, r, i]
                assert not bool((h & ~s).any()), f"band {k} region ({r}, {i}) misses a hit"


def _rehearsal_lists(inp):
    """The kernel's staging, window by window of each band: -> list of
    ((b, band, window row, window), x0 of the window, list of flat face ids
    chunk * 128 + lane in (chunk, lane) order)."""
    B, NB = inp.geom.shape[:2]
    xbin_w = inp.tile[0]
    lists = []
    for b in range(B):
        for k in range(NB):
            for wy in range(-(-inp.height // T)):
                c0, c1 = inp.tiles[b, k, wy].tolist()
                for wx in range(-(-xbin_w // T)):
                    x0, y0 = k * xbin_w + wx * T, wy * T
                    if x0 >= inp.width:
                        continue
                    ids = []
                    for c in range(c0, c1):
                        cb = inp.chunk_box[b, k, c].tolist()
                        if not (cb[0] < x0 + T and cb[1] > x0 and cb[2] < y0 + T
                                and cb[3] > y0):
                            continue
                        fb = inp.face_box[b, k, c]
                        keep = ((fb[:, 0] < x0 + T) & (fb[:, 1] > x0) & (fb[:, 2] < y0 + T)
                                & (fb[:, 3] > y0))
                        ids.append(c * rc.LANE + torch.nonzero(keep)[:, 0])
                    lists.append(((b, k, wy, wx), x0,
                                  torch.cat(ids) if ids else torch.zeros(0, dtype=torch.long)))
    return lists


def _rehearse(inp):
    """The kernel's pass 1 as it schedules it: every window stages its faces
    in order, each 8 x 8 region scans those whose box meets it, each pixel
    keeping the key with strict >, and a window writes the pixels of its
    band's columns in the image. -> (best key, best chunk), each (B, H * W)
    int32, as ``_nearest_face_torch``; and the windows' lists."""
    B, NB, NC = inp.geom.shape[:3]
    lists = _rehearsal_lists(inp)
    n_max = max(max(len(ids) for _, _, ids in lists), 1)
    ids = torch.full((len(lists), n_max), -1, dtype=torch.long)
    for i, (_, _, f) in enumerate(lists):
        ids[i, :len(f)] = f
    b = torch.tensor([w[0] for w, _, _ in lists])
    k = torch.tensor([w[1] for w, _, _ in lists])
    i = torch.arange(T * T)
    region = (i // T) // R * (T // R) + (i % T) // R  # the pixel's warp, row-major
    px = torch.tensor([x0 for _, x0, _ in lists])[:, None] + i % T
    py = torch.tensor([w[2] for w, _, _ in lists])[:, None] * T + i // T
    x, y = px.float() + 0.5, py.float() + 0.5
    planes = inp.geom.transpose(-2, -1).reshape(B, NB, -1, rc.N_ROWS)  # (B, NB, NC * 128, 16)
    boxes = inp.face_box.reshape(B, NB, -1, 4)
    best = torch.zeros_like(x, dtype=torch.int32)
    best_chunk = torch.zeros_like(best)
    rx0, ry0 = (region % (T // R)) * R, (region // (T // R)) * R  # each pixel's region origin
    for e in range(n_max):
        f = ids[:, e]
        g = planes[b, k, f.clamp_min(0)][:, :, None]  # (L, 16, 1)
        fb = boxes[b, k, f.clamp_min(0)][:, None]  # (L, 1, 4)
        qx, qy = px[:, :1] + rx0, py[:, :1] + ry0
        scans = ((f >= 0)[:, None] & (fb[..., 0] < qx + R) & (fb[..., 1] > qx)
                 & (fb[..., 2] < qy + R) & (fb[..., 3] > qy))
        lam0 = x * g[:, 0] + y * g[:, 2] + g[:, 4]
        lam1 = x * g[:, 1] + y * g[:, 3] + g[:, 5]
        lam2 = 1.0 - lam0 - lam1
        wbits = (x * g[:, 6] + y * g[:, 7] + g[:, 8]).view(torch.int32)
        hit = (lam0 >= -1e-6) & (lam1 >= -1e-6) & (lam2 >= -1e-6) & (wbits > 0) & scans
        key = (wbits & ~0x7F) | (f % rc.LANE).int()[:, None]
        win = hit & (key > best)
        best = torch.where(win, key, best)
        best_chunk = torch.where(win, torch.div(f, rc.LANE, rounding_mode="floor").int()[:, None],
                                 best_chunk)
    x_end = torch.clamp((k + 1) * inp.tile[0], max=inp.width)[:, None]
    inside = (px < x_end) & (py < inp.height)
    out_key = torch.full((B, inp.height * inp.width), -1, dtype=torch.int32)
    out_chunk = torch.zeros_like(out_key)
    flat = (py * inp.width + px)[inside]
    bb = b[:, None].expand_as(px)[inside]
    assert not bool((out_key[bb, flat] != -1).any())
    out_key[bb, flat] = best[inside]
    out_chunk[bb, flat] = best_chunk[inside]
    assert not bool((out_key == -1).any()), "a pixel no window writes"
    return out_key, out_chunk, lists


@pytest.mark.parametrize("name", sorted(CASES_1D))
def test_rehearsed_band_schedule_bit_equal_to_twin(name, monkeypatch):
    inp = _inputs(CASES_1D[name])
    key, chunk, lists = _rehearse(inp)
    seen, orig = {}, rc._nearest_face_torch

    def spy(*a, **kw):
        seen["winners"] = orig(*a, **kw)
        return seen["winners"]

    monkeypatch.setattr(rc, "_nearest_face_torch", spy)
    want = rc.rasterize_batch_rgb_binned_torch(*inp.twin_args())
    want_key, want_chunk = seen["winners"]
    assert torch.equal(key, want_key) and torch.equal(chunk, want_chunk)
    assert bool((key > 0).any()) != name.startswith("tie_cull1")
    # the twin's outputs from the rehearsed winners
    monkeypatch.setattr(rc, "_nearest_face_torch", lambda *a, **kw: (key, chunk))
    for a, r in zip(rc.rasterize_batch_rgb_binned_torch(*inp.twin_args()), want):
        assert torch.equal(a, r)
    # the 128-face list is refilled where a window stages more: the 700-face scenes
    if name.startswith(("multi", "invalid")):
        assert max(len(ids) for _, _, ids in lists) > 128


def test_band_evaluations_counted_by_hand():
    """One image of 16 x 24 pixels in bands of 5 columns: bands [0, 5),
    [5, 10), [10, 15), [15, 20) and [20, 24), one 16 x 16 window each,
    starting at the band's left edge, with regions at its x0 and x0 + 8,
    rows 0 and 8. Face A has vertices (10.5, 4.5), (13.5, 4.5), (10.5,
    7.5): its bbox [10.5, 13.5] puts a valid copy in the band [10, 15)
    only, and its box is [8, 16) x [2, 10). That band's regions sit at
    x 10 and 18: A's box meets the two at x 10, of which the band writes
    5 columns x 8 rows each. So 2 x 40 evaluations."""
    verts = torch.tensor([[[10.5, 4.5, 1.0], [13.5, 4.5, 1.0], [10.5, 7.5, 1.0]]])
    faces = torch.tensor([[0, 1, 2]])
    inp = rc.kernel_tables(rc.prepare_raster_binned(verts, torch.full((1, 3, 3), 0.5), faces,
                                                    None, 16, 24, 5, 4))
    x0, cols = region_columns(inp)
    assert x0.tolist() == [[0, 8], [5, 13], [10, 18], [15, 23], [20, 28]]
    assert cols.tolist() == [[5, 0], [5, 0], [5, 0], [5, 0], [4, 0]]
    empty = [rc.BOX_LIMIT, -rc.BOX_LIMIT, rc.BOX_LIMIT, -rc.BOX_LIMIT]
    assert inp.face_box[0, :, 0, 0].tolist() == [empty] * 2 + [[8, 16, 2, 10]] + [empty] * 2
    scanned = scanned_faces(inp)  # (5 bands, 2 region rows, 2 regions, 1 chunk, 128)
    assert scanned.shape == (5, 2, 2, 1, rc.LANE)
    none = [[0, 0], [0, 0]]
    assert scanned.sum((-1, -2)).tolist() == [none, none, [[1, 0], [1, 0]], none, none]
    assert face_evaluations(inp) == 2 * 40
    # the 1-D layout: one band of the image's width, regions at x 0, 8, 16
    one = rc.kernel_tables(rc.prepare_raster(verts, torch.full((1, 3, 3), 0.5), faces, None,
                                             16, 24))
    x0, cols = region_columns(one)
    assert x0.tolist() == [[0, 8, 16, 24]] and cols.tolist() == [[8, 8, 8, 0]]
    # A's box [8, 16) x [2, 10) meets the regions at x 8, rows 0 and 8: 2 x 64
    assert face_evaluations(one) == 2 * 64


def test_tile_over_2048_px_bit_equal_to_jax(jax_big):
    args = [torch.from_numpy(BIG[k]) for k in ("verts", "rgb", "faces", "valid")]
    rgb, depth = rc.rasterize_batch_rgb(*args, BIG["H"], BIG["W"], xbin_w=128, tile_rows=32)
    assert BIG["xbin_w"] * BIG["tile_rows"] > 2048 and float((depth > 0).float().mean()) > 0.3
    np.testing.assert_array_equal(rgb.numpy(), jax_big["big/rgb"])
    np.testing.assert_array_equal(depth.numpy(), jax_big["big/depth"])
    # and the kernel's schedule at that tile gives the twin's winners
    inp = _inputs(BIG)
    key, chunk, _ = _rehearse(inp)
    want = rc._nearest_face_torch(inp.ranges, inp.geom, inp.height, inp.width, inp.tile)
    assert torch.equal(key, want[0]) and torch.equal(chunk, want[1])
