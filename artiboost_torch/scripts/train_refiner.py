"""Train the grasp-validity RefineNet (counterpart of
``script/train_refiner.py``; GrabNet's ``refinenet.pt`` does not load into
this re-designed net, so it trains here): clean grasps from the grasp
library, corrupted by the synthesis scrambler, and the unrolled refinement
learns to recover the clean hand (vertex, joint and contact recovery) under
random global rotations. Ends with the held-out recovery: the mean vertex
error of scrambled hands before and after refinement.

Usage:
    python -m artiboost_torch.scripts.train_refiner --steps 2000 --batch 256 \\
        --out assets/refinenet_tpu.npz [--device cpu]
The npz is the JAX package's flat layout: ``build_refiner`` (REFINER
``TYPE: hand_obj``, ``PRETRAINED: <npz>``) loads it here and in JAX."""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict

import numpy as np
import torch

from artiboost_torch.artiboost.grasp_library import get_grasp_library
from artiboost_torch.artiboost.object_library import get_object_library
from artiboost_torch.artiboost.refiner import (RefineNet, RefinerTrainStep, make_ho_refiner,
                                               save_refiner_params)
from artiboost_torch.artiboost.scrambler import Scrambler
from artiboost_torch.mano.layer import mano_forward
from artiboost_torch.mano.model import get_mano_model
from artiboost_torch.utils.misc import LOG_FORMAT, logger, resolve_device

HO3D_OBJS = ["003_cracker_box", "006_mustard_bottle", "010_potted_meat_can",
             "021_bleach_cleanser"]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n_grasp", type=int, default=50)
    ap.add_argument("--obj_points", type=int, default=2048,
                    help="object surface points fed to the chamfer search")
    ap.add_argument("--scrambler", default="random_2")
    ap.add_argument("--pose_sigma", type=float, default=0.3)
    ap.add_argument("--tsl_sigma", type=float, default=0.02)
    ap.add_argument("--objs", nargs="*", default=None,
                    help="YCB object names (default: the HO3D set)")
    ap.add_argument("--dataset_type", default="HO3D")
    ap.add_argument("--out", default="assets/refinenet_tpu.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_freq", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    """-> {"losses": per-step metrics, "ms_per_step" (steps after the
    first), "scrambled_mm", "refined_mm", "out", "net" (the trained net)}."""
    args = parse(argv)
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt="%H:%M:%S")
    device = resolve_device(args.device)
    objs = args.objs or HO3D_OBJS
    mano = get_mano_model(device=device)
    obj_lib = get_object_library(objs, args.dataset_type, device=device)
    grasp_lib = get_grasp_library(objs, args.n_grasp, device=device)
    n_obj, n_grasp = grasp_lib.hand_pose.shape[:2]
    scrambler = Scrambler({"TYPE": args.scrambler, "HAND_POSE_SIGMA": args.pose_sigma,
                           "HAND_TSL_SIGMA": args.tsl_sigma})

    # the object points once, a fixed subset bounding the chamfer search
    v_max = obj_lib.verts.shape[1]
    sel = torch.from_numpy(np.random.RandomState(args.seed).choice(
        v_max, min(args.obj_points, v_max), replace=False)).to(device)
    obj_verts_all, obj_valid_all = obj_lib.verts[:, sel], obj_lib.vert_valid[:, sel]

    torch.manual_seed(args.seed)
    net = RefineNet().to(device)
    step = RefinerTrainStep(mano, net, scrambler, n_iters=args.iters, learning_rate=args.lr)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)

    def sample(B):
        oid = torch.randint(0, n_obj, (B,), generator=gen, device=device)
        gid = torch.randint(0, n_grasp, (B,), generator=gen, device=device)
        return oid, grasp_lib.gather(oid, gid)

    losses, t0, t1 = [], time.perf_counter(), None
    for i in range(args.steps):
        oid, (pose, shape, tsl) = sample(args.batch)
        metrics = step(step.draws(gen, args.batch), pose, shape, tsl, obj_verts_all[oid],
                       obj_valid_all[oid])
        losses.append(metrics)
        if i == 0:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        if i % args.log_freq == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            logger.info(f"step {i:5d}  loss {m['loss']:.5f}  verts {m['l_verts']:.5f}  "
                        f"joints {m['l_joints']:.5f}  contact {m['l_contact']:.5f}  "
                        f"({time.perf_counter() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / max(args.steps - 1, 1)
    save_refiner_params(net, args.out)
    logger.info(f"saved refiner params to {args.out}")

    # held-out recovery: scrambled against refined vertex error
    refine = make_ho_refiner(mano, net.eval(), n_iters=args.iters)
    errs = []
    with torch.no_grad():
        for _ in range(4):
            oid, (pose, shape, tsl) = sample(args.batch)
            clean = mano_forward(mano, pose, shape)
            clean_verts = clean.verts + tsl[:, None]
            scram = scrambler({"hand_pose": pose, "hand_tsl": tsl,
                               "joints": clean.joints + tsl[:, None], "hand_verts": clean_verts,
                               "hand_transf": clean.transforms_abs},
                              scrambler.draws(gen, args.batch, device))
            sv = mano_forward(mano, scram["hand_pose"], shape).verts + scram["hand_tsl"][:, None]
            ref = refine({"hand_pose": scram["hand_pose"], "hand_tsl": scram["hand_tsl"],
                          "hand_shape": shape}, obj_verts_all[oid], obj_valid_all[oid])
            errs.append((float(torch.linalg.norm(sv - clean_verts, dim=-1).mean()),
                         float(torch.linalg.norm(ref["hand_verts"] - clean_verts, dim=-1).mean())))
    es, er = (float(np.mean(x)) for x in zip(*errs))
    logger.info(f"recovery eval: scrambled verts err {1000 * es:.2f} mm -> refined "
                f"{1000 * er:.2f} mm ({100 * (1 - er / max(es, 1e-9)):.1f}% recovered)")
    return {"losses": [{k: float(v) for k, v in m.items()} for m in losses],
            "ms_per_step": ms, "scrambled_mm": 1000 * es, "refined_mm": 1000 * er,
            "out": args.out, "net": net}


if __name__ == "__main__":
    main()
