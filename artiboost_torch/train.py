"""ArtiBoost epoch loop on PyTorch (counterpart of
``train/train_artiboost.py:283,340-367``).

Slice 1 runs the synthesis-and-mining part of each epoch: the startup
``prepare()`` (the reference runs it at startup AND at the top of every
epoch, which double-counts the occurrence map; kept for parity), then per
epoch ``prepare()``, and when ``should_val``: ``prepare_val()``, the
forward-only val pass over ``iter_val()`` feeding the evaluator, then
``step_eval()`` (the ``method_1`` reweight). The train pass (losses,
Adam, the mixed real/synth batch) arrives in slice 2 in this function.

Usage:
    python -m artiboost_torch.train --cfg config/ho3dv2_clasbased_artiboost.yaml \
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
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.models.arch import build_arch
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


def run(cfg: Dict, epochs: Optional[int] = None, device=None,
        model_state: Optional[Dict[str, torch.Tensor]] = None,
        draws: Optional[DrawSource] = None, timer: Optional[StageTimer] = None) -> Dict:
    """Run the slice-1 epoch loop. ``device`` None means CUDA (raises
    without one). ``model_state`` is a HybridBaseline state dict (e.g. from
    ``hybrid_baseline_from_flax``); without it the weights are torch's
    initialisation under TRAIN.MANUAL_SEED. Returns the loader, evaluator,
    model and val-pass counts."""
    device = resolve_device(device)
    data_preset = cfg["DATA_PRESET"]
    batch_size = int(cfg["TRAIN"]["BATCH_SIZE"])
    n_epochs = int(cfg["TRAIN"]["EPOCH"]) if epochs is None else int(epochs)
    seed = int(cfg["TRAIN"].get("MANUAL_SEED", 1))
    timer = timer or StageTimer(device)

    evaluator = build_evaluator(cfg.get("EVALUATOR", []), device=device)
    loader = ArtiBoostLoader(cfg=slice_config(cfg), batch_size=batch_size,
                             n_epochs=n_epochs, seed=seed, device=device, draws=draws)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        arch = build_arch(cfg["ARCH"], data_preset)
    if model_state is not None:
        arch.model_list[0].load_state_dict(model_state)
    arch = arch.to(device).eval()

    t = timer.mark()
    loader.prepare()
    t = timer.add("pose sweep", t)
    n_val_batches = n_val_images = 0
    for epoch in range(n_epochs):
        t = timer.mark()
        loader.prepare()
        t = timer.add("pose sweep", t)
        logger.info(f"epoch {epoch}: the train pass arrives in slice 2; "
                    "running the synthesis-and-mining pass")
        if loader.should_val(epoch):
            loader.prepare_val()
            t = timer.add("pose sweep", t)
            evaluator.reset_all()
            with torch.inference_mode():
                for batch in loader.iter_val():
                    t = timer.add("synth batch", t)
                    preds = arch(batch)
                    t = timer.add("forward", t)
                    evaluator.feed_all(preds, batch)
                    t = timer.add("metric+mining", t)
                    n_val_batches += 1
                    n_val_images += int(batch["image"].shape[0])
        loader.step_eval(epoch, evaluator)
        t = timer.add("metric+mining", t)
    return {"loader": loader, "evaluator": evaluator, "model": arch, "timer": timer,
            "n_val_batches": n_val_batches, "n_val_images": n_val_images}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt="%H:%M:%S")
    out = run(load_config(args.cfg), epochs=args.epochs, device=args.device)
    ccv = out["loader"].ccv
    logger.info(f"done: {out['n_val_batches']} val batches; weight map "
                f"[{float(ccv.sample_weight_map.min()):.3f}, "
                f"{float(ccv.sample_weight_map.max()):.3f}]")


if __name__ == "__main__":
    main()
