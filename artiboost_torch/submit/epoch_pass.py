"""Evaluation and Codalab-submission pass over a test split (counterpart of
``artiboost_tpu/submit/epoch_pass.py``; reference
``anakin/submit/submit_epoch_pass.py`` and
``hodata_submit_epoch_pass.py``): the split through the model into the
evaluator, and on request the HO3D Codalab JSON of joints (the
MANO-native order, the x-flip, then the whole negation) and fitted
meshes, zipped for upload, and overlays of the first batches."""
from __future__ import annotations

import json
import os
import zipfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries
from artiboost_torch.parallel import mesh
from artiboost_torch.utils.misc import logger
from artiboost_torch.utils.transform import MANO_TO_OPENPOSE_ORDER


class SubmitEpochPass:
    """Registry of the passes by ``--submit_dataset``."""

    build_mapping: Dict[str, type] = {}

    @staticmethod
    def build(cata: str, **cfg) -> "SubmitEpochPass":
        return SubmitEpochPass.build_mapping[cata](**cfg)

    @classmethod
    def register(cls, key):
        def deco(sub):
            cls.build_mapping[key] = sub
            return sub
        return deco


@SubmitEpochPass.register("hodata")
class HOSubmitEpochPass(SubmitEpochPass):
    # box corner index = bit(x) * 4 + bit(y) * 2 + bit(z) (the object
    # library's corner order) -> the cuboid's 12 triangles
    BOX_TRIS = np.asarray(
        [(0, 1, 3), (0, 3, 2), (4, 5, 7), (4, 7, 6),
         (0, 1, 5), (0, 5, 4), (2, 3, 7), (2, 7, 6),
         (0, 2, 6), (0, 6, 4), (1, 3, 7), (1, 7, 5)], np.int64)

    def __init__(self, arg=None, fitting_unit=None, **cfg):
        """``arg``: the command line's flags (``submit_dump``,
        ``postprocess_fit_mesh``, ``postprocess_fit_mesh_use_fitted_joints``,
        ``postprocess_draw``, ``postprocess_draw_path``); without it the
        config keys DUMP, FIT_MESH, DRAW, DRAW_PATH. DRAW_MAX_BATCHES (4)
        bounds the batches drawn."""
        def flag(name, key):
            return bool(getattr(arg, name, False)) if arg else cfg.get(key, False)

        self.dump = flag("submit_dump", "DUMP")
        self.fit_mesh = flag("postprocess_fit_mesh", "FIT_MESH")
        self.fit_mesh_use_fitted_joints = bool(
            getattr(arg, "postprocess_fit_mesh_use_fitted_joints", False)) if arg else False
        self.fitting_unit = fitting_unit
        self.draw = flag("postprocess_draw", "DRAW")
        self.draw_path = (getattr(arg, "postprocess_draw_path", None) if arg
                          else cfg.get("DRAW_PATH")) or "exp/draw"
        self.draw_max_batches = int(cfg.get("DRAW_MAX_BATCHES", 4))

    @staticmethod
    def get_order_idxs():
        reorder_idxs = list(MANO_TO_OPENPOSE_ORDER)
        return reorder_idxs, np.argsort(reorder_idxs)

    def dump_json(self, pred_out_path: str, xyz_pred_list: List[np.ndarray],
                  verts_pred_list: List[np.ndarray], codalab: bool = True) -> None:
        """HO3D's official format: the JSON [joints, verts], each value
        rounded to 5 decimals, and a deflated zip of it under its basename."""

        def roundall(rows):
            return [[round(float(v), 5) for v in row] for row in rows]

        xyz = [roundall(np.asarray(x).tolist()) for x in xyz_pred_list]
        verts = [roundall(np.asarray(v).tolist()) for v in verts_pred_list]
        with open(pred_out_path, "w") as fo:
            json.dump([xyz, verts], fo)
        logger.info(f"dumped {len(xyz)} joints / {len(verts)} verts to {pred_out_path}")
        if codalab:
            zipped = pred_out_path.replace(".json", ".zip")
            with zipfile.ZipFile(zipped, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.write(pred_out_path, os.path.basename(pred_out_path))
            logger.warning(f"finished — submit {zipped} to Codalab for evaluation")

    def draw_batch(self, bidx: int, batch: Dict, preds: Dict,
                   fitted_verts: Optional[np.ndarray] = None) -> None:
        """``eval_batch_<bidx>.png``: a grid of the first 16 images, each
        with the fitted hand (MANO skin tone) and the predicted object box
        shaded and rasterized as one scene (``render_mesh_overlay``, on
        the batch's device), then the predicted skeleton and corner cube
        (hodata_submit_epoch_pass.py:158-222)."""
        from PIL import Image

        from artiboost_torch.viztools.draw import (
            draw_corners_2d, draw_skeleton_2d, image_grid, project_points, render_mesh_overlay)

        os.makedirs(self.draw_path, exist_ok=True)
        image = batch[Queries.IMAGE]
        imgs = image.float().cpu().numpy() + 0.5
        intr = batch[Queries.CAM_INTR].float().cpu().numpy()
        joints = preds["joints_3d_abs"].float().cpu().numpy()
        corners = (preds["corners_3d_abs"].float().cpu().numpy()
                   if "corners_3d_abs" in preds else None)
        hand_faces = (self.fitting_unit.mano_model.faces.cpu().numpy()
                      if fitted_verts is not None else None)
        tiles = []
        for i in range(min(imgs.shape[0], 16)):
            tile = Image.fromarray((imgs[i] * 255).clip(0, 255).astype(np.uint8))
            meshes = []
            if fitted_verts is not None:
                meshes.append((fitted_verts[i], hand_faces, (0.8, 0.62, 0.52)))
            if corners is not None:
                meshes.append((corners[i], self.BOX_TRIS, (0.35, 0.6, 0.9)))
            if meshes:
                render_mesh_overlay(tile, meshes, intr[i], device=image.device)
            draw_skeleton_2d(tile, project_points(joints[i], intr[i]))
            if corners is not None:
                draw_corners_2d(tile, project_points(corners[i], intr[i]))
            tiles.append(np.asarray(tile))
        image_grid(tiles, ncol=4).save(os.path.join(self.draw_path, f"eval_batch_{bidx:04d}.png"))

    def _drawn_rows(self, batch: Dict, preds: Dict, fitted_verts: Optional[torch.Tensor]):
        """What ``draw_batch`` reads of the global batch, on every rank:
        under a process group the first 16 rows of the image, intrinsics,
        joints, corners and fitted verts, gathered in rank order (each rank
        sends at most its first 16, so the first 16 gathered are the global
        batch's); one process's batch as it is."""
        if mesh.world() > 1:
            k = min(int(batch[Queries.IMAGE].shape[0]), 16)

            def take(t):
                return mesh.all_gather_rows(t[:k].float())[:16]

            batch = {q: take(batch[q]) for q in (Queries.IMAGE, Queries.CAM_INTR)}
            preds = {q: take(preds[q]) for q in ("joints_3d_abs", "corners_3d_abs") if q in preds}
            fitted_verts = None if fitted_verts is None else take(fitted_verts)
        return batch, preds, None if fitted_verts is None else fitted_verts.cpu().numpy()

    def __call__(self, epoch_idx: int, eval_step: Callable, data_loader, evaluator,
                 dump_path: Optional[str] = None):
        """Run ``eval_step(batch) -> (preds, losses)`` over the loader into
        the evaluator; fit, draw and collect the Codalab rows as asked.

        Under a process group each rank evaluates its rows of every global
        batch (``padded_host_loader(rows=...)``): the evaluator is fed with
        the global batch's valid count and reduced over the ranks after the
        pass; each rank fits its own rows, then the joints, fitted verts and
        SAMPLE_VALID are gathered in rank order, so the rows are the global
        batch's in the dataset's order; only rank 0 draws (``draw_batch``
        on the gathered first rows) and writes the JSON and zip."""
        _, unorder_idxs = self.get_order_idxs()
        lead = mesh.rank() == 0
        res_joints: List[np.ndarray] = []
        res_verts: List[np.ndarray] = []
        for bidx, batch in enumerate(data_loader):
            preds, losses = eval_step(batch)
            valid = batch.get(Queries.SAMPLE_VALID)
            if valid is not None and mesh.world() > 1:
                # every rank of a padded tail batch holds its rows of the mask
                valid = mesh.all_gather_rows(valid)
                evaluator.feed_all(preds, batch, losses, n_global=int(valid.sum()))
            else:
                evaluator.feed_all(preds, batch, losses)
            if not (self.dump or self.fit_mesh or self.draw):
                continue
            pred_joints = preds["joints_3d_abs"].detach()
            fitted_verts = None
            if self.fit_mesh and self.fitting_unit is not None:
                fitted = self.fitting_unit(pred_joints, batch)
                fitted_verts = fitted["hand_verts"]
                if self.fit_mesh_use_fitted_joints:
                    pred_joints = fitted["joints"]
            if self.draw and bidx < self.draw_max_batches:
                drawn = self._drawn_rows(batch, preds, fitted_verts)
                if lead:
                    self.draw_batch(bidx, *drawn)
            if not (self.dump or self.fit_mesh):
                continue
            pred_joints = mesh.all_gather_rows(pred_joints.float()).cpu().numpy()
            if fitted_verts is not None:
                fitted_verts = mesh.all_gather_rows(fitted_verts.float()).cpu().numpy()
            # the repeat-padded tail rows must not reach the dump: Codalab
            # expects exactly len(dataset) entries
            n_valid = pred_joints.shape[0] if valid is None else int(valid.sum())
            # HO3D's Codalab convention: MANO-native joint order, y/z flip
            pj = pred_joints[:n_valid, unorder_idxs]
            pj[:, :, 0] = -pj[:, :, 0]
            res_joints.extend([-p for p in pj])
            if fitted_verts is not None:
                # the reference appends the fitted verts RAW, in the camera
                # frame (hodata_submit_epoch_pass.py:148-149), though its
                # joints take the (x, -y, -z) flip: kept for file fidelity
                res_verts.extend([v for v in fitted_verts[:n_valid]])
            else:
                res_verts.extend([np.zeros((778, 3))] * pj.shape[0])
        if mesh.world() > 1:
            evaluator.all_reduce()
        if self.dump and dump_path and lead:
            self.dump_json(dump_path, res_joints, res_verts, codalab=True)
        return evaluator
