"""Checkpoint-parity harness (counterpart of ``script/eval_parity.py``):
point it at a released reference ``.pth.tar`` and a dataset root, and it
prints the evaluator's measures (Mean3DEPE per key and the rest) and the
MPCPE row to compare with the paper's table.

It builds the config's model, loads the checkpoint through
``utils/pretrained.py`` (the reference's tensor names, renamed per model
type; it stops if nothing loads: a figure from a random init means
nothing), evaluates the TEST split with ``padded_host_loader`` (the tail
batch repeat-padded and masked by SAMPLE_VALID, the host halves of an
on-disk split made ahead by ``utils/prefetch.py``), and prints the
measures as JSON and the MPCPE line (``corners_3d_abs_mepe``, else AR's
MSSD). Hand MPJPE on HO3D's evaluation split needs the Codalab server, as
in the reference: ``artiboost_torch.submit_reload --submit_dump`` writes
its zip.

Usage:
    python -m artiboost_torch.scripts.eval_parity \\
        --cfg config_eval/eval_ho3dv2_clasbased_artiboost.yaml \\
        --ckpt checkpoints/artiboost_ho3dv2_clasbased_100e.pth.tar \\
        --data_root ./data [--expected_mpcpe 25.3] [--batch_size 100] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.hodata import padded_host_loader
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel.train_state import eval_step
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.prefetch import HostPipeline
from artiboost_torch.utils.pretrained import load_arch_pretrained


def main(argv=None) -> Dict:
    """-> {"row": the printed measures, "mpcpe": the MPCPE (mm) or None,
    "batches"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--ckpt", required=True, help="released .pth.tar")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--expected_mpcpe", type=float, default=None,
                    help="paper-row MPCPE (mm) to diff against")
    ap.add_argument("--max_batches", type=int, default=0,
                    help="debug: stop after N batches (0 = full split)")
    ap.add_argument("--workers", type=int, default=20, help="host image decode threads")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    arg = ap.parse_args(argv)
    device = resolve_device(arg.device)

    cfg = load_config(arg.cfg)
    cfg["ARCH"]["PRETRAINED"] = arg.ckpt
    if arg.data_root:
        cfg["DATASET"]["TEST"]["DATA_ROOT"] = arg.data_root
    preset = cfg["DATA_PRESET"]
    batch_size = arg.batch_size or int(cfg.get("TRAIN", {}).get("BATCH_SIZE", 100))
    test_data = build_dataset(cfg["DATASET"]["TEST"], preset, device=device)
    arch = build_arch(cfg["ARCH"], preset)
    if not load_arch_pretrained(arch, cfg["ARCH"]):
        raise SystemExit(f"checkpoint {arg.ckpt} did not load — aborting "
                         f"(a parity number from random init is meaningless)")
    model = arch.to(device).eval()
    criterion = build_criterion(cfg) if cfg.get("CRITERION") else None
    evaluator = build_evaluator(cfg.get("EVALUATOR", []), preset, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(1)

    t0 = time.time()
    n = 0
    host = HostPipeline(arg.workers) if test_data.images_on_host else None
    try:
        for batch in padded_host_loader(test_data, batch_size, host=host):
            with torch.no_grad():
                if criterion is None:
                    preds, losses = model(batch), {}
                else:
                    preds, losses = eval_step(model, criterion, batch,
                                              criterion.draws(generator, device))
            evaluator.feed_all(preds, batch, losses)
            n += 1
            if arg.max_batches and n >= arg.max_batches:
                break
    finally:
        if host is not None:
            host.close()
    logger.info(f"eval: {n} batches in {time.time() - t0:.1f}s")

    row = {}
    for metric in evaluator.metrics_list:
        row.update(metric.get_measures())
    mpcpe = row.get("corners_3d_abs_mepe") or row.get("MSSD")
    shown = {k: round(float(v), 3) for k, v in row.items() if isinstance(v, (int, float))}
    print(json.dumps(shown, indent=2))
    if mpcpe is not None:
        line = f"MPCPE (mm): {float(mpcpe):.2f}"
        if arg.expected_mpcpe is not None:
            line += (f"  |  paper row: {arg.expected_mpcpe:.2f}  |  delta: "
                     f"{float(mpcpe) - arg.expected_mpcpe:+.2f} mm")
        print(line)
    return {"row": shown, "mpcpe": None if mpcpe is None else float(mpcpe), "batches": n}


if __name__ == "__main__":
    main()
