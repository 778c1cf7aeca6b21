"""Evaluate a checkpoint on a test split and write the HO3D Codalab
submission (counterpart of ``train/submit_reload.py``).

``main_worker`` builds the TEST split, the model, the criterion and the
evaluator from the config's ``DATA_PRESET``, loads the weights (``--reload``,
a checkpoint of ``artiboost_torch.train``; else ``--resume``'s
``checkpoints/latest.pt``; else ``ARCH.PRETRAINED`` through
``utils/pretrained.py``; else torch's initialisation under
TRAIN.MANUAL_SEED, with a warning), runs ``HOSubmitEpochPass`` over the
padded loader (the tail batch repeat-padded and masked by SAMPLE_VALID)
and records the evaluator as ``test`` under ``exp/eval_<exp_id>_<time>/``.
``--submit_dump`` writes ``pred_<type>.json`` and its zip there;
``--postprocess_fit_mesh`` fits a MANO mesh to each prediction
(``postprocess/fitting.py``); ``--postprocess_draw`` draws the first
batches' overlays into ``--postprocess_draw_path``.

Usage:
    python -m artiboost_torch.submit_reload --cfg config_eval/eval_ho3dv2_clasbased_artiboost.yaml \\
        [--reload exp/<dir>/checkpoints/latest.pt] [--submit_dump] [--postprocess_fit_mesh] \\
        [--postprocess_fit_mesh_ik iknet|iksolver] [--postprocess_draw] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional

import torch

from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.hodata import padded_host_loader
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.submit.epoch_pass import SubmitEpochPass
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import LOG_FORMAT, logger, resolve_device
from artiboost_torch.utils.pretrained import load_arch_pretrained
from artiboost_torch.utils.prefetch import HostPipeline
from artiboost_torch.utils.recorder import Recorder


def build_parser() -> argparse.ArgumentParser:
    """The flags of ``artiboost_tpu/opt.py`` that this path reads, and the
    port's ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, help="evaluation config (config_eval/*.yaml)")
    ap.add_argument("--reload", default=None, help="checkpoint to evaluate (latest.pt)")
    ap.add_argument("--resume", default=None,
                    help="experiment directory whose checkpoints/latest.pt to evaluate")
    ap.add_argument("--exp_id", default="default")
    ap.add_argument("--batch_size", type=int, default=None, help="overrides TRAIN.BATCH_SIZE")
    ap.add_argument("--workers", type=int, default=20, help="host image decode threads")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--submit_dataset", default="hodata")
    ap.add_argument("--submit_dump", action="store_true")
    ap.add_argument("--postprocess_fit_mesh", action="store_true")
    ap.add_argument("--postprocess_fit_mesh_ik", choices=["iknet", "iksolver"], default="iknet")
    ap.add_argument("--postprocess_fit_mesh_use_fitted_joints", action="store_true")
    ap.add_argument("--postprocess_draw", action="store_true")
    ap.add_argument("--postprocess_draw_path", default=None)
    return ap


def load_weights(arch, cfg: Dict, reload_path: Optional[str]) -> str:
    """``reload_path`` (a checkpoint's ``model``, the state dict of the whole
    arch as ``utils/recorder.py`` saves it) where it exists, else
    ARCH.PRETRAINED, else the initialisation as built. -> what was loaded."""
    if reload_path and os.path.exists(reload_path):
        payload = torch.load(reload_path, map_location="cpu", weights_only=True)
        arch.load_state_dict(payload["model"])
        logger.info(f"reloaded checkpoint from {reload_path} (epoch {payload['epoch']})")
        return reload_path
    if load_arch_pretrained(arch, cfg["ARCH"]):
        logger.info("evaluating ARCH.PRETRAINED weights")
        return "ARCH.PRETRAINED"
    logger.warning(f"no checkpoint at {reload_path} and no loadable ARCH.PRETRAINED; "
                   "evaluating random init")
    return "random init"


def main_worker(arg, cfg: Dict, device=None) -> Dict:
    """One evaluation pass -> {"measures", "dump_path", "pred_path" (None
    without ``submit_dump``), "weights", "batches", "seconds"}."""
    device = resolve_device(device)
    recorder = Recorder(arg.exp_id, cfg, eval_only=True)
    try:
        data_preset = cfg["DATA_PRESET"]
        batch_size = int(cfg.get("TRAIN", {}).get("BATCH_SIZE", 100))
        test_data = build_dataset(cfg["DATASET"]["TEST"], data_preset, device=device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("TRAIN", {}).get("MANUAL_SEED", 1)))
            arch = build_arch(cfg["ARCH"], data_preset)
        reload_path = arg.reload or os.path.join(arg.resume or "", "checkpoints", "latest.pt")
        weights = load_weights(arch, cfg, reload_path)
        model = arch.to(device).eval()
        criterion = build_criterion(cfg) if cfg.get("CRITERION") else None
        evaluator = build_evaluator(cfg.get("EVALUATOR", []), data_preset, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

        def eval_step(batch):
            preds = model(batch)
            if criterion is None:
                return preds, {}
            return preds, criterion.compute_losses(preds, batch,
                                                   criterion.draws(generator, device))[1]

        fitting_unit = None
        if arg.postprocess_fit_mesh:
            from artiboost_torch.postprocess.fitting import FittingUnit

            fitting_unit = FittingUnit(ik_mode=arg.postprocess_fit_mesh_ik, device=device)
        pass_ = SubmitEpochPass.build(arg.submit_dataset, arg=arg, fitting_unit=fitting_unit)
        pred_path = os.path.join(
            recorder.dump_path,
            f"pred_{cfg['DATASET']['TEST'].get('TYPE', 'ho3d').lower()}.json")
        host = HostPipeline(arg.workers) if test_data.images_on_host else None
        batches = [0]

        def counted(loader):
            for batch in loader:
                batches[0] += 1
                yield batch

        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                pass_(0, eval_step, counted(padded_host_loader(test_data, batch_size, host=host)),
                      evaluator, dump_path=pred_path if arg.submit_dump else None)
        finally:
            if host is not None:
                host.close()
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        logger.info(f"eval pass done in {seconds:.1f}s")
        measures = recorder.record_evaluator(evaluator, 0, "test")
        logger.info(f"measures: {measures}")
        return {"measures": measures, "dump_path": recorder.dump_path,
                "pred_path": pred_path if arg.submit_dump else None, "weights": weights,
                "batches": batches[0], "seconds": seconds}
    finally:
        recorder.close()


def main(argv=None) -> Dict:
    arg = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt="%H:%M:%S")
    device = resolve_device(arg.device)
    cfg = load_config(arg.cfg)
    if arg.batch_size:
        cfg.setdefault("TRAIN", {})["BATCH_SIZE"] = arg.batch_size
    return main_worker(arg, cfg, device)


if __name__ == "__main__":
    main()
