"""Mining A/B (counterpart of ``script/mining_ab.py``): does CCV reweighting
improve accuracy over uniform sampling? The same seeds, epochs, model and
optimizer for every method; only ``MANAGER.UPDATE_METHOD`` changes.

Per run one JSON line:
  * the final TEST Mean3DEPE (mm) on the held-out synthetic test split,
  * the per-triplet val-EPE distribution (p10/p50/p90/max/mean over seen
    triplets) at the last epoch, before its reweight: mining should
    compress the tail;
then one summary line per method.

Every run trains through the port's own train epoch (``train.train_epoch``,
pipelined as ``TRAIN.PIPELINE_SYNTH`` says, default on) and val sweep.

Usage:
    python -m artiboost_torch.scripts.mining_ab [--epochs 30] [--seeds 1 2] \\
        [--methods method_1 method_4 uniform] [--cfg config/mining_ab.yaml] [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from artiboost_torch import train
from artiboost_torch.artiboost.loader import ArtiBoostLoader
from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel.train_state import TrainStep
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import logger, resolve_device

CFG = "config/mining_ab.yaml"


class Variant:
    """One run's parts, built as ``train.run`` builds them: the train split,
    the model (torch's initialisation under the run's seed), criterion,
    evaluators, the ArtiBoostLoader (its startup ``prepare()`` made, as
    the JAX scripts make it) and the train step."""

    def __init__(self, cfg: Dict, seed: int, epochs: int, device: torch.device,
                 test: bool = False):
        self.cfg, self.device = cfg, device
        preset = cfg["DATA_PRESET"]
        self.batch_size = int(cfg["TRAIN"]["BATCH_SIZE"])
        self.train_data = build_dataset(cfg["DATASET"]["TRAIN"], preset, device=device)
        metrics = cfg.get("EVALUATOR", [])
        self.evaluator = build_evaluator(metrics, preset, device=device)
        self.test_evaluator = build_evaluator(
            [m for m in metrics if not m["TYPE"].startswith("ValMetric")], preset,
            device=device) if test else None
        self.criterion = build_criterion(cfg)
        self.loader = ArtiBoostLoader(self.train_data, cfg=train.slice_config(cfg),
                                      batch_size=self.batch_size, n_epochs=epochs, seed=seed,
                                      device=device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.arch = build_arch(cfg["ARCH"], preset)
        self.step = TrainStep(self.arch, self.criterion, cfg["TRAIN"], device=device)
        self.timer = train.StageTimer(device)
        self.pipeline = bool(cfg["TRAIN"].get("PIPELINE_SYNTH", True))
        self.loader.prepare()

    def train_epoch(self, epoch: int) -> Dict:
        """The epoch's train pass (the caller has made its ``prepare()``)."""
        return train.train_epoch(self.loader, self.step, self.evaluator, self.timer,
                                 pipeline=self.pipeline, epoch=epoch)

    def val_epoch(self, epoch: int) -> Optional[Dict]:
        """The val sweep when ``should_val``, refilling the evaluator."""
        if not self.loader.should_val(epoch):
            return None
        self.loader.prepare_val()
        return train.val_epoch(self.loader, self.arch, self.criterion, self.evaluator,
                               self.timer, epoch)

    def val_maps(self):
        """(per-triplet val EPE, seen mask) of ValMetricMean3DEPE2, on the host."""
        for metric in self.evaluator.metrics_list:
            if isinstance(metric, ValMetricMean3DEPE2):
                vmap, seen = metric.get_averaged_maps()
                return vmap.cpu().numpy(), seen.cpu().numpy()
        return None


def config_for(cfg_base: Dict, method: str, seed: int, epochs: int) -> Dict:
    cfg = copy.deepcopy(cfg_base)
    cfg["TRAIN"]["MANUAL_SEED"] = seed
    cfg["TRAIN"]["EPOCH"] = epochs
    cfg["MANAGER"]["UPDATE_METHOD"] = method
    return cfg


def run_variant(method: str, seed: int, epochs: int, test_data, cfg_base: Dict,
                device) -> Dict:
    run = Variant(config_for(cfg_base, method, seed, epochs), seed, epochs, device, test=True)
    loader = run.loader
    t0 = time.time()
    val_dist = None
    for epoch in range(epochs):
        loader.prepare()
        run.train_epoch(epoch)
        run.val_epoch(epoch)
        if epoch == epochs - 1:  # the last epoch's distribution, before its reweight
            maps = run.val_maps()
            vals = maps[0][maps[1]] if maps is not None else np.zeros(0)
            if vals.size:
                val_dist = {"n_seen": int(vals.size),
                            "p10": float(np.percentile(vals, 10)),
                            "p50": float(np.percentile(vals, 50)),
                            "p90": float(np.percentile(vals, 90)),
                            "max": float(vals.max()), "mean": float(vals.mean())}
        loader.step_eval(epoch, run.evaluator)

    train.test_epoch(test_data, run.batch_size, run.arch, run.criterion, run.test_evaluator,
                     loader.draws, run.timer, epoch=epochs)
    measures = {}
    for metric in run.test_evaluator.metrics_list:
        measures.update(metric.get_measures())
    weight_spread = float(loader.ccv.sample_weight_map.std(correction=0))  # np.std
    loader.synth_shutdown()
    row = {
        "method": method,
        "seed": seed,
        "epochs": epochs,
        "train_s": round(time.time() - t0, 1),
        "test_joints_mepe_mm": round(float(
            measures.get("joints_3d_abs_mepe", float("nan"))), 3),
        "test_corners_mepe_mm": round(float(
            measures.get("corners_3d_abs_mepe", float("nan"))), 3),
        "val_epe_dist_mm": {k: round(v, 2) for k, v in (val_dist or {}).items()},
        "final_weight_spread": round(weight_spread, 4),
    }
    print(json.dumps(row), flush=True)
    return row


def summary(rows: List[Dict], methods: List[str]) -> List[Dict]:
    out = []
    for m in methods:
        sel = [r for r in rows if r["method"] == m]
        mj = np.mean([r["test_joints_mepe_mm"] for r in sel])
        mc = np.mean([r["test_corners_mepe_mm"] for r in sel])
        out.append({"method": m, "mean_test_joints_mepe_mm": round(float(mj), 3),
                    "mean_test_corners_mepe_mm": round(float(mc), 3), "n_runs": len(sel)})
    return out


def main(argv=None) -> Dict:
    """-> {"rows": one dict per run, "summary": one per method}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--methods", nargs="+", default=["method_1", "method_4", "uniform"])
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    arg = ap.parse_args(argv)
    device = resolve_device(arg.device)

    cfg = load_config(arg.cfg)
    test_data = build_dataset(cfg["DATASET"]["TEST"], cfg["DATA_PRESET"], device=device)
    rows = []
    for seed in arg.seeds:
        for method in arg.methods:
            logger.info(f"=== mining A/B: {method} seed {seed} ===")
            rows.append(run_variant(method, seed, arg.epochs, test_data, cfg, device))
    print("=== SUMMARY ===")
    lines = summary(rows, arg.methods)
    for line in lines:
        print(json.dumps(line))
    return {"rows": rows, "summary": lines}


if __name__ == "__main__":
    main()
