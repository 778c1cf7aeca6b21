"""Standalone ArtiBoost synthesis visualizer (counterpart of
``script/viz_artiboost_render.py``; reference
``script/viz_artiboost_render.py``): run the engine end to end (triplet
sampling, pose generation, the render through kernel B1, or B2 with
``--flat``) without a real dataset, and save the rendered synth samples
with their ground-truth skeleton and corner cube (``synth_<i>.png``,
``synth_grid.png``), and the same grid with the ground-truth hand mesh and
object box shaded over each image by ``viztools/draw.py``'s
``render_mesh_overlay``, which rasterizes through kernel B2
(``synth_mesh_grid.png``).

Usage:
    python -m artiboost_torch.scripts.viz_artiboost_render \\
        --cfg config/ho3dv2_clasbased_artiboost.yaml --n_samples 16 --out exp/viz_synth \\
        [--seed 0] [--flat] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
from PIL import Image

from artiboost_torch.artiboost.loader import ArtiBoostLoader
from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.submit.epoch_pass import HOSubmitEpochPass
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.viztools.draw import (
    draw_corners_2d,
    draw_skeleton_2d,
    image_grid,
    render_mesh_overlay,
)

HAND_RGB, BOX_RGB = (0.8, 0.62, 0.52), (0.35, 0.6, 0.9)  # the submission's overlay colours


def main(argv=None) -> Dict:
    """-> {"out": the directory, "pngs": the files written, "batch": the
    synth batch drawn}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default="config/ho3dv2_clasbased_artiboost.yaml")
    ap.add_argument("--n_samples", type=int, default=16)
    ap.add_argument("--out", default="exp/viz_synth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flat", action="store_true",
                    help="Gouraud vertex colours (kernel B2) instead of the default per-pixel "
                         "texture sampling (kernel B1)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.cfg)
    manager_cfg = dict(cfg["MANAGER"])
    manager_cfg["DATA_PRESET"] = cfg.get("DATA_PRESET", {})
    manager_cfg["CONFIG_LEN_TRAIN"] = max(args.n_samples, 8)
    if args.flat:
        manager_cfg["RENDERER"] = dict(manager_cfg.get("RENDERER", {}), TEXTURED=False)
    loader = ArtiBoostLoader(real_dataset=None, cfg=manager_cfg, batch_size=args.n_samples,
                             seed=args.seed, device=device)
    logger.info("generating synth poses ...")
    loader.prepare()
    batch = next(iter(loader))
    os.makedirs(args.out, exist_ok=True)

    def host(key):
        return batch[key].detach().float().cpu().numpy()

    imgs = host(Queries.IMAGE) + 0.5  # de-normalize
    joints_2d, corners_2d = host(Queries.JOINTS_2D), host(Queries.CORNERS_2D)
    root = host(Queries.ROOT_JOINT)[:, None]
    hand_verts, corners = host(Queries.HAND_VERTS_3D) + root, host(Queries.CORNERS_3D) + root
    intr = host(Queries.CAM_INTR)
    hand_faces = loader.mano_model.faces.cpu().numpy()
    tiles, mesh_tiles, pngs = [], [], []
    for i in range(imgs.shape[0]):
        base = Image.fromarray((imgs[i] * 255).clip(0, 255).astype(np.uint8))
        for meshes, out in ((None, tiles), (True, mesh_tiles)):
            tile = base.copy()
            if meshes:
                render_mesh_overlay(tile, [(hand_verts[i], hand_faces, HAND_RGB),
                                           (corners[i], HOSubmitEpochPass.BOX_TRIS, BOX_RGB)],
                                    intr[i], device=device)
            draw_skeleton_2d(tile, joints_2d[i])
            draw_corners_2d(tile, corners_2d[i])
            out.append(np.asarray(tile))
        pngs.append(os.path.join(args.out, f"synth_{i:03d}.png"))
        Image.fromarray(tiles[-1]).save(pngs[-1])
    ncol = int(np.ceil(np.sqrt(len(tiles))))
    for name, group in (("synth_grid.png", tiles), ("synth_mesh_grid.png", mesh_tiles)):
        pngs.append(os.path.join(args.out, name))
        image_grid(group, ncol=ncol).save(pngs[-1])
    logger.info(f"saved {len(tiles)} overlaid synth samples -> {args.out}")
    return {"out": args.out, "pngs": pngs, "batch": batch}


if __name__ == "__main__":
    main()
