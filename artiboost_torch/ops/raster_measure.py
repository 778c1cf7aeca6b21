"""What the raster kernels' measurements count (``chip_smoke.py`` prints
them; ``tests/test_torch_raster_cull.py`` and
``tests/test_torch_raster_binned_cull.py`` hold them on the CPU): the work
the inputs need, for a kernel's bound; the faces the kernels' tables leave
each warp; and the instruction mix of the compiled kernels' loops, read
from ``cuobjdump -sass``. Nothing on the raster's path imports this
module."""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Tuple

import torch

from artiboost_torch.ops.rasterizer_cuda import (
    LANE,
    RASTER_REGION,
    RASTER_TILE,
    TILE_PX,
    RasterInputs,
    face_boxes,
)

BYTES_WRITTEN_PER_PIXEL = 16  # uv: quv, qsp, win, depth; rgb: r, g, b, depth; 4 B each
GEOM_ROWS = 9                 # geometry rows pass 1 reads of a face


def raster_work(inp: RasterInputs, n_attr: int) -> Tuple[int, int, int]:
    """What a raster kernel's inputs need, for its bound: -> (bytes read,
    bytes written, pixel x face-box pairs). Read, each element once: the 9
    geometry rows of every valid face (of every band's valid copy for the
    binned raster), the 3 ``n_attr`` colour rows that pass 2 reads of each
    (n_attr 4 for the uv kernel, 3 for r, g, b; at most, as only a winner's
    are read), and the range table (the 1-D one of the twins, or the binned
    one). No padding, and no table derived for a kernel alone. Written: 16 B
    a pixel. Pairs: for every valid face, the pixels of its ``face_boxes``
    box in the image, within its band's columns for the binned raster."""
    geom = inp.geom
    lead, n_chunks = tuple(geom.shape[:-3]), geom.shape[-3]
    valid = geom[..., 4, :] > -1e29  # invalid and padded faces carry ec0' = -1e30
    if inp.tile:
        range_elems = inp.ranges.numel()
    else:
        range_elems = lead[0] * -(-inp.height * inp.width // TILE_PX) * 2
    read = int(valid.sum()) * (GEOM_ROWS + 3 * n_attr) * 4 + range_elems * 4
    H, W = inp.height, inp.width
    box = face_boxes(geom.reshape((-1, n_chunks) + tuple(geom.shape[-2:])))
    box = box.reshape(lead + (n_chunks, LANE, 4)).long()
    if inp.tile:  # binned: band k holds the columns [k xbin_w, (k + 1) xbin_w)
        xbin_w, n_bands = inp.tile[0], lead[1]
        x_lo = (torch.arange(n_bands, device=box.device) * xbin_w)[:, None, None]
        nx = (torch.minimum(box[..., 1], (x_lo + xbin_w).clamp(max=W))
              - torch.maximum(box[..., 0], x_lo))
    else:
        nx = box[..., 1].clamp(max=W) - box[..., 0].clamp(min=0)
    ny = box[..., 3].clamp(max=H) - box[..., 2].clamp(min=0)
    pairs = int((nx.clamp_min(0) * ny.clamp_min(0)).sum())
    return read, BYTES_WRITTEN_PER_PIXEL * lead[0] * H * W, pairs


def region_columns(inp: RasterInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (NB, RX) first column of each RASTER_REGION-wide warp region of a
    row of the kernels' windows, and how many of its columns the kernel
    writes. A band's windows start at its left edge and write only its
    columns; the uv and Gouraud layout is one band of the image's width."""
    t, r = RASTER_TILE, RASTER_REGION
    xbin_w = inp.tile[0] if inp.tile else inp.width
    lo = torch.arange(-(-inp.width // xbin_w), device=inp.geom.device) * xbin_w
    x0 = lo[:, None] + torch.arange(-(-xbin_w // t) * (t // r), device=lo.device) * r
    hi = torch.clamp(lo + xbin_w, max=inp.width)
    return x0, (hi[:, None] - x0).clamp(0, r)


def scanned_faces(inp: RasterInputs) -> torch.Tensor:
    """(N, RY, RX, NC, 128) bool: the faces the kernels evaluate in each
    RASTER_REGION x RASTER_REGION region of each image (B3: of each band of
    an image, N = B NB; regions as ``region_columns``), one warp's pixels:
    those of the chunks in its window row's range whose chunk box meets its
    window and whose own box meets the region. ``inp`` carries the
    kernels' tables (``kernel_tables``)."""
    t, r = RASTER_TILE, RASTER_REGION
    NC = inp.geom.shape[-3]
    tiles = inp.tiles.reshape(-1, inp.tiles.shape[-2], 2)
    chunk_box = inp.chunk_box.reshape(-1, NC, 1, 4)
    face_box = inp.face_box.reshape(-1, NC, LANE, 4)
    dev = inp.geom.device
    x0, _ = region_columns(inp)
    x0 = x0.repeat(tiles.shape[0] // x0.shape[0], 1)  # (N, RX): image n is band n % NB
    window_x0 = x0 - (x0 - x0[:, :1]) % t
    y0 = torch.arange(-(-inp.height // t) * (t // r), device=dev) * r

    def meets(box, xs, ys, n):  # (N, NC, m, 4), (N, RX), (RY,) -> (N, RY, RX, NC, m)
        box = box[:, None]
        xs, ys = xs[:, :, None, None], ys[:, None, None]
        in_x = (box[..., 0] < xs + n) & (box[..., 1] > xs)  # (N, RX, NC, m)
        in_y = (box[..., 2] < ys + n) & (box[..., 3] > ys)  # (N, RY, NC, m)
        return in_y[:, :, None] & in_x[:, None]

    c = torch.arange(NC, device=dev)
    in_range = (c >= tiles[..., :1]) & (c < tiles[..., 1:])  # (N, TY, NC)
    in_range = in_range[:, torch.div(y0, t, rounding_mode="floor")]  # (N, RY, NC)
    chunk_in = meets(chunk_box, window_x0, y0 - y0 % t, t)
    return in_range[:, :, None, :, None] & chunk_in & meets(face_box, x0, y0, r)


def face_evaluations(inp: RasterInputs) -> float:
    """Face evaluations of this input's pass 1 that reach a written pixel:
    each warp region's pixels that its kernel writes times the faces the
    tables leave it (``scanned_faces``)."""
    r = RASTER_REGION
    n_faces = scanned_faces(inp).sum((-1, -2)).double()  # (N, RY, RX)
    _, cols = region_columns(inp)
    cols = cols.repeat(n_faces.shape[0] // cols.shape[0], 1)  # (N, RX)
    rows = torch.clamp(inp.height - torch.arange(n_faces.shape[1], device=cols.device) * r, 0, r)
    return float((n_faces * (rows[None, :, None] * cols[:, None, :]).double()).sum())


_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


def _mnemonic(op: str) -> str:
    """SASS opcode -> its mnemonic, with a load or store's width kept
    (``LDS.128``, ``LDG.E.64`` -> ``LDG.64``)."""
    parts = op.split(".")
    width = [p for p in parts[1:] if p in ("64", "128")]
    return parts[0] + ("." + width[0] if width and parts[0][:2] in ("LD", "ST") else "")


def sass_counts(text: str) -> Dict[str, dict]:
    """``cuobjdump -sass`` (or ``nvdisasm``) listing -> {function: {"all":
    Counter of mnemonics, "loop": Counter of the smallest loop that holds a
    float add or multiply, "loop_len": its instructions}}. A loop is the
    span from a backward branch's target to the branch."""
    out, name, instrs, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        ops = [_mnemonic(op) for _, op, _ in instrs]
        best = None
        for addr, op, rest in instrs:
            target = _SASS_TARGET.search(rest) if op.startswith("BRA") else None
            if target is None:
                continue
            t = labels.get(target.group(1))
            t = int(target.group(1), 16) if t is None and target.group(1).startswith("0x") else t
            if t is None or t > addr:
                continue
            body = [ops[j] for j, (a, _, _) in enumerate(instrs) if t <= a <= addr]
            if any(o in ("FADD", "FMUL", "FFMA") for o in body) and (
                    best is None or len(body) < len(best)):
                best = body
        out[name] = {"all": Counter(ops), "loop": Counter(best or ()),
                     "loop_len": len(best or ())}

    for line in text.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            close()
            name, instrs, labels = m.group(1), [], {}
            continue
        m = _SASS_LABEL.match(line)
        if m:  # the address of the instruction after it; SASS instructions are 16 B
            labels[m.group(1)] = instrs[-1][0] + 16 if instrs else 0
            continue
        m = _SASS_INSTR.search(line)
        if m and name is not None:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return out
