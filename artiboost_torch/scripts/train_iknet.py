"""Train IKNet (counterpart of ``script/train_iknet.py``): random MANO
poses, their FK joints normalised as ``FittingUnit`` normalises them, and
supervised per-joint quaternions plus FK joint recovery. Ends with the
held-out fitting residual: ``FittingUnit``'s joint error with the trained
warm start on 64 seeded poses.

Usage:
    python -m artiboost_torch.scripts.train_iknet --steps 4000 \\
        --out assets/iknet_tpu.npz [--device cpu]
``FittingUnit`` reads ``assets/iknet_tpu.npz``; the file is the JAX
package's flat layout, which its ``load_iknet_params`` reads too."""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from artiboost_torch.mano.layer import mano_forward
from artiboost_torch.mano.model import get_mano_model
from artiboost_torch.postprocess.fitting import (FittingUnit, IKNetTrainStep, load_iknet_params,
                                                 save_iknet_params)
from artiboost_torch.postprocess.iknet import IKNet
from artiboost_torch.utils.misc import logger, resolve_device


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="assets/iknet_tpu.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_freq", type=int, default=250)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """-> {"losses": per-step metrics, "ms_per_step" (steps after the
    first), "fit_err_mm", "out", "net" (the trained net)}."""
    args = parse(argv)
    device = resolve_device(args.device)
    mano = get_mano_model(device=device)
    torch.manual_seed(args.seed)
    net = IKNet().to(device)
    step = IKNetTrainStep(mano, net, learning_rate=args.lr)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)

    losses, t0, t1 = [], time.perf_counter(), None
    for i in range(args.steps):
        metrics = step(step.draws(gen))
        losses.append(metrics)
        if i == 0:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if i % args.log_freq == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            logger.info(f"step {i:5d}  loss {m['loss']:.5f}  quat {m['l_quat']:.5f}  "
                        f"joints {m['l_joints']:.5f}  ({time.perf_counter() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / max(args.steps - 1, 1)
    save_iknet_params(net, args.out)
    logger.info(f"saved iknet params to {args.out}")

    # held-out: the fitting residual with the trained warm start
    fit = FittingUnit(mano, iknet_state=load_iknet_params(args.out), device=device)
    pose = torch.from_numpy(np.random.RandomState(123).randn(64, 48).astype(np.float32) * 0.2)
    with torch.no_grad():
        out = mano_forward(mano, pose.to(device), torch.zeros((64, 10), device=device))
    joints = out.joints + torch.tensor([0.0, 0.0, 0.5], device=device)
    res = fit(joints)
    err = float(torch.linalg.norm(res["joints"] - joints, dim=-1).mean())
    logger.info(f"fitting residual joint err (trained init): {err * 1000:.2f} mm")
    return {"losses": [{k: float(v) for k, v in m.items()} for m in losses],
            "ms_per_step": ms, "fit_err_mm": 1000 * err, "out": args.out, "net": net}


if __name__ == "__main__":
    main()
