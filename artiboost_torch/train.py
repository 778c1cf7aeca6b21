"""ArtiBoost training on PyTorch (counterpart of
``train/train_artiboost.py:240-370``).

``run`` builds the train dataset (``DATASET.TRAIN``), the model, the
criterion, the evaluator and the ArtiBoostLoader, runs the startup
``prepare()`` (the reference runs it at startup AND at the top of every
epoch, which double-counts the occurrence map; kept for parity), then per
epoch: ``prepare()``; the train epoch over mixed real+synth batches (the
real half from the dataset, the synth half rendered from the epoch's
poses, joined over the key union, then the train step, the evaluator fed
with preds, batch and losses); when ``should_val``, ``prepare_val()`` and
the val pass, which refills the evaluator; then ``step_eval()`` (the
mining reweight) from whatever the evaluator holds, so an epoch without a
val sweep mines from the train epoch as the JAX package does.
Checkpoints (``utils/recorder.py``) are not ported yet.

Usage:
    python -m artiboost_torch.train --cfg config/synthetic_smoke.yaml \\
        [--epochs N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import logging
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from artiboost_torch.artiboost.loader import ArtiBoostLoader, DrawSource
from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import Evaluator, build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel.train_state import TrainStep, eval_step
from artiboost_torch.utils.batching import union_concat
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import LOG_FORMAT, logger, resolve_device


class StageTimer:
    """Host seconds per named stage; synchronizes CUDA at each boundary so
    device work is charged to the stage that queued it."""

    def __init__(self, device: torch.device):
        self.sync = device.type == "cuda"
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def mark(self):
        if self.sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def add(self, stage: str, t0: float) -> float:
        t1 = self.mark()
        self.seconds[stage] += t1 - t0
        self.calls[stage] += 1
        return t1


def slice_config(cfg: Dict) -> Dict:
    """The MANAGER node with DATA_PRESET and the val gates injected (the
    reference train_artiboost.py:166-167 injects them the same way)."""
    manager = dict(cfg.get("MANAGER", {}))
    manager.setdefault("DATA_PRESET", cfg["DATA_PRESET"])
    train = cfg.get("TRAIN", {})
    if "EVAL_FREQ" in train:
        manager.setdefault("VAL_FREQ", train["EVAL_FREQ"])
    if "VAL_START_EPOCH" in train:
        manager.setdefault("VAL_START_EPOCH", train["VAL_START_EPOCH"])
    return manager


def train_epoch(loader: ArtiBoostLoader, step: TrainStep, evaluator: Evaluator,
                timer: StageTimer) -> Dict:
    """One train epoch: -> {"steps", "images", "seconds" (host wall clock
    of the epoch), "final_loss": [per-step device scalars]}."""
    evaluator.reset_all()
    out = {"steps": 0, "images": 0, "final_loss": []}
    t = t_start = timer.mark()
    for real, sidx in loader.iter_parts():
        t = timer.add("real batch", t)
        synth = None if sidx is None else loader.synth_part(sidx)
        t = timer.add("synth batch", t)
        batch = union_concat([p for p in (real, synth) if p])
        preds, losses = step(batch, loader.draws.loss(step.criterion))
        t = timer.add("train step", t)
        evaluator.feed_all(preds, batch, losses)
        t = timer.add("metric+mining", t)
        out["steps"] += 1
        out["images"] += int(batch["image"].shape[0])
        out["final_loss"].append(losses["final_loss"])
    out["seconds"] = timer.mark() - t_start
    return out


def val_epoch(loader: ArtiBoostLoader, model: torch.nn.Module, criterion,
              evaluator: Evaluator, timer: StageTimer) -> Dict:
    """The val sweep: pure-synth batches through the model with its running
    statistics, the evaluator refilled. -> {"batches", "images"}."""
    evaluator.reset_all()
    out = {"batches": 0, "images": 0}
    t = timer.mark()
    for batch in loader.iter_val():
        t = timer.add("synth batch", t)
        preds, losses = eval_step(model, criterion, batch, loader.draws.loss(criterion))
        t = timer.add("forward", t)
        evaluator.feed_all(preds, batch, losses)
        t = timer.add("metric+mining", t)
        out["batches"] += 1
        out["images"] += int(batch["image"].shape[0])
    return out


def run(cfg: Dict, epochs: Optional[int] = None, device=None,
        model_state: Optional[Dict[str, torch.Tensor]] = None,
        draws: Optional[DrawSource] = None, timer: Optional[StageTimer] = None) -> Dict:
    """Train for ``epochs`` (default TRAIN.EPOCH). ``device`` None means
    CUDA (raises without one). ``model_state`` is a HybridBaseline state
    dict (e.g. from ``hybrid_baseline_from_flax``); without it the weights
    are torch's initialisation under TRAIN.MANUAL_SEED. ``draws`` replaces
    the loader's random draws. Returns the loader, evaluator, model, train
    step, timer and the per-epoch counts."""
    device = resolve_device(device)
    data_preset = cfg["DATA_PRESET"]
    batch_size = int(cfg["TRAIN"]["BATCH_SIZE"])
    n_epochs = int(cfg["TRAIN"]["EPOCH"]) if epochs is None else int(epochs)
    seed = int(cfg["TRAIN"].get("MANUAL_SEED", 1))
    timer = timer or StageTimer(device)

    t = timer.mark()
    train_data = None
    if "TRAIN" in cfg.get("DATASET", {}):
        train_data = build_dataset(cfg["DATASET"]["TRAIN"], data_preset, device=device)
    t = timer.add("dataset init", t)
    evaluator = build_evaluator(cfg.get("EVALUATOR", []), device=device)
    criterion = build_criterion(cfg)
    loader = ArtiBoostLoader(train_data, cfg=slice_config(cfg), batch_size=batch_size,
                             n_epochs=n_epochs, seed=seed, device=device, draws=draws)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        arch = build_arch(cfg["ARCH"], data_preset)
    if model_state is not None:
        arch.model_list[0].load_state_dict(model_state)
    step = TrainStep(arch, criterion, cfg["TRAIN"], device=device)

    t = timer.mark()
    loader.prepare()
    t = timer.add("pose sweep", t)
    history = []
    for epoch in range(n_epochs):
        t = timer.mark()
        loader.prepare()
        timer.add("pose sweep", t)
        record = {"epoch": epoch, "train": train_epoch(loader, step, evaluator, timer)}
        record["train"]["measures"] = evaluator.get_measures_all()
        if loader.should_val(epoch):
            t = timer.mark()
            loader.prepare_val()
            timer.add("pose sweep", t)
            record["val"] = val_epoch(loader, arch, criterion, evaluator, timer)
            record["val"]["measures"] = evaluator.get_measures_all()
        t = timer.mark()
        loader.step_eval(epoch, evaluator)
        timer.add("metric+mining", t)
        record["train"]["final_loss"] = [float(v) for v in record["train"]["final_loss"]]
        logger.info(f"epoch {epoch}: {record['train']['steps']} train steps, "
                    f"{record.get('val', {}).get('batches', 0)} val batches | {evaluator}")
        history.append(record)
    return {"loader": loader, "evaluator": evaluator, "model": arch, "step": step,
            "timer": timer, "history": history, "train_data": train_data}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt="%H:%M:%S")
    out = run(load_config(args.cfg), epochs=args.epochs, device=args.device)
    w = out["loader"].ccv.sample_weight_map
    losses = [v for r in out["history"] for v in r["train"]["final_loss"]]
    logger.info(f"done: {len(losses)} train steps, final_loss {losses[0]:.5f} -> "
                f"{losses[-1]:.5f}; weight map [{float(w.min()):.3f}, {float(w.max()):.3f}]")


if __name__ == "__main__":
    main()
