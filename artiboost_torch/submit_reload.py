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
``--filter_unseen_obj_idxs`` drops those objects' rows from every corner
EPE, over the config's FILTER_UNSEEN_OBJ_IDXS (``build_evaluator(ARG=...)``).

Data parallelism (JAX ``submit_reload.py:80-84``): ``--n_devices N`` spawns
N local ranks, one a card (gloo where ranks share one), when the batch
tiles them, else one process evaluates; ``--multihost`` with the rank
flags joins a process group as training does. Each rank loads the
weights, rank 0's are broadcast, each evaluates its rows of every padded
batch and fits their meshes, and the metrics reduce over the global batch;
rank 0 gathers the rows, draws and writes the experiment, the JSON and the
zip. The command line is JAX's (``utils/opt.py``); a flag the submission
does not read is logged as having no effect.

Usage:
    python -m artiboost_torch.submit_reload --cfg config_eval/eval_ho3dv2_clasbased_artiboost.yaml \\
        [--reload exp/<dir>/checkpoints/latest.pt] [--submit_dump] [--postprocess_fit_mesh] \\
        [--postprocess_fit_mesh_ik iknet|iksolver] [--postprocess_draw] [--device cuda|cpu] \\
        [--filter_unseen_obj_idxs ID ...] [--n_devices N]
    python -m artiboost_torch.submit_reload --cfg ... --multihost --coordinator localhost:29500 \\
        --num_processes 2 --process_id {0,1}
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from typing import Dict, Optional

import torch

from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.hodata import padded_host_loader
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel import mesh
from artiboost_torch.submit.epoch_pass import SubmitEpochPass
from artiboost_torch.utils import opt
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.pretrained import load_arch_pretrained
from artiboost_torch.utils.prefetch import HostPipeline
from artiboost_torch.utils.recorder import NullRecorder, Recorder


def build_parser() -> argparse.ArgumentParser:
    """Every flag of ``artiboost_tpu/opt.py`` (``utils/opt.py``) and the
    submission's ``--reload``."""
    ap = opt.build_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--reload", default=None, help="checkpoint to evaluate (latest.pt)")
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


def eval_batch_size(cfg: Dict) -> int:
    return int(cfg.get("TRAIN", {}).get("BATCH_SIZE", 100))


def state_digest(module: torch.nn.Module) -> str:
    """sha256 of the module's parameters and buffers, in state-dict order."""
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main_worker(arg, cfg: Dict, device=None) -> Dict:
    """One evaluation pass -> {"measures", "dump_path", "pred_path" (None
    without ``submit_dump``), "weights", "batches", "seconds", "ranks",
    "param_digests" (each rank's ``state_digest`` after the load)}. Under a
    process group each rank evaluates its rows of every batch (the batch
    must tile the ranks), rank 0's weights are broadcast, and rank 0 alone
    records the experiment: on the others ``dump_path`` and ``pred_path``
    are None."""
    device = resolve_device(device)
    world = mesh.world()
    batch_size = eval_batch_size(cfg)
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} does not tile {world} ranks")
    recorder = Recorder(arg.exp_id, cfg, eval_only=True) if mesh.rank() == 0 else NullRecorder()
    try:
        data_preset = cfg["DATA_PRESET"]
        test_data = build_dataset(cfg["DATASET"]["TEST"], data_preset, device=device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("TRAIN", {}).get("MANUAL_SEED", 1)))
            arch = build_arch(cfg["ARCH"], data_preset)
        reload_path = arg.reload or os.path.join(arg.resume or "", "checkpoints", "latest.pt")
        weights = load_weights(arch, cfg, reload_path)
        model = arch.to(device).eval()
        mesh.broadcast_module(model)
        digests = mesh.gather_objects(state_digest(model))
        if mesh.rank() == 0:
            logger.info(f"{world} rank(s); each rank's state after the load (sha256): {digests}")
        criterion = build_criterion(cfg) if cfg.get("CRITERION") else None
        # ARG: the command line's --filter_unseen_obj_idxs over the config's
        # FILTER_UNSEEN_OBJ_IDXS (JAX submit_reload.py:51)
        evaluator = build_evaluator(cfg.get("EVALUATOR", []), data_preset, device=device,
                                    ARG=arg)
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
        pred_path = None
        if arg.submit_dump and recorder.dump_path is not None:
            pred_path = os.path.join(
                recorder.dump_path,
                f"pred_{cfg['DATASET']['TEST'].get('TYPE', 'ho3d').lower()}.json")
        host = HostPipeline(arg.workers) if test_data.images_on_host else None
        rows = mesh.rows(batch_size) if world > 1 else None
        batches = [0]

        def counted(loader):
            for batch in loader:
                batches[0] += 1
                yield batch

        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                pass_(0, eval_step, counted(padded_host_loader(test_data, batch_size, host=host,
                                                               rows=rows)),
                      evaluator, dump_path=pred_path)
        finally:
            if host is not None:
                host.close()
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        logger.info(f"eval pass done in {seconds:.1f}s (rank {mesh.rank()} of {world})")
        if mesh.rank() == 0:
            measures = recorder.record_evaluator(evaluator, 0, "test")
            logger.info(f"measures: {measures}")
        else:
            measures = evaluator.get_measures_all_striped()
        return {"measures": measures, "dump_path": recorder.dump_path, "pred_path": pred_path,
                "weights": weights, "batches": batches[0], "seconds": seconds, "ranks": world,
                "param_digests": digests}
    finally:
        recorder.close()


def main(argv=None) -> Dict:
    """The command line -> ``main_worker``'s result (rank 0's under a
    process group). ``--n_devices N`` without ``--multihost`` spawns N
    local ranks, one a card (``mesh.spawn_ranks``, as training does), when
    the batch tiles them; when it does not, one process evaluates, as JAX's
    submission then drops its mesh (``submit_reload.py:80-84``), and the
    result says ``ranks`` 1."""
    ap = build_parser()
    arg = ap.parse_args(argv)
    if not arg.cfg:
        ap.error("--cfg is required")
    device = resolve_device(arg.device)
    cfg = load_config(arg.cfg)
    if arg.batch_size:
        cfg.setdefault("TRAIN", {})["BATCH_SIZE"] = arg.batch_size
    n = arg.n_devices or 1
    if n > 1 and not arg.multihost:
        if eval_batch_size(cfg) % n == 0:
            return mesh.spawn_ranks(main, sys.argv[1:] if argv is None else argv, n,
                                    keep_result=True)
        logger.warning(f"a batch of {eval_batch_size(cfg)} does not tile {n} ranks: one "
                       "process evaluates")
    opt.log_unread(arg, ap, opt.NO_EFFECT + opt.TRAIN_ONLY)
    joined = arg.multihost and mesh.init_distributed(
        arg.coordinator, arg.num_processes, arg.process_id, device_type=device.type)
    try:
        return main_worker(arg, cfg, mesh.rank_device(device))
    finally:
        if joined:
            mesh.close()


if __name__ == "__main__":
    main()
