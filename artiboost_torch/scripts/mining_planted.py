"""Planted-hard-region mining experiments (counterpart of
``script/mining_planted.py``): does the mining loop concentrate weight on
a region made hard on purpose? Three plants, selected by ``--plant``:

``noise``: object 0 x the first quarter of the view bins gets N(0, sigma)
noise added to its joint and corner TARGETS in both train and val
synthesis. The model cannot fit the noise, so the region's val EPE is high
by construction: the loop must concentrate weight there, which shows as the
region's weight-mass ratio against uniform's exact 1.000.

``withhold``: all of object 0 is masked out of the TRAIN draw for the first
``--release_frac`` of the epochs (the val sweep, which draws uniformly,
still measures it), then released; the paired per-seed delta of the
region's final val EPE against the uniform control is the accuracy payoff.

``offset``: object 0's joint and corner targets get a FIXED offset of
``--sigma`` metres (train AND val): learnable, but only from object-0
samples.

Each plant wraps the loader's ``synth_batch_fn`` (``PlantedSynth``), as the
JAX script's ``corrupt_wrap`` and ``offset_wrap`` wrap its synth function
(:93-139), so train and val batches carry it; the noise comes from a
generator of its own seeded from the run's seed (the loader's draws are
untouched). Every run trains through the port's own train epoch,
pipelined as ``TRAIN.PIPELINE_SYNTH`` says (default on). One JSON line per
run, then per method the mean and 95 % CI over seeds, and the paired
payoff against ``uniform``.

Usage:
    python -m artiboost_torch.scripts.mining_planted --plant noise [--epochs 20] \\
        [--seeds 1 2 3 4] [--sigma 0.1] [--methods method_1 uniform] [--val_len 384] \\
        [--cfg config/mining_ab.yaml] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from artiboost_torch.datasets.hoquery import Queries, SynthQueries
from artiboost_torch.scripts.mining_ab import CFG, Variant, config_for
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.misc import logger, resolve_device

# planted region: object 0 x the first quarter of the view bins (all grasps)
HARD_OBJ = 0
NOISE_SEED_OFFSET = 7919  # the JAX script folds seed + 7919 into its key
OFFSET_DIR = (0.48, 0.64, 0.6)  # |OFFSET_DIR| = 1


def region_mask(obj_id, persp_id, plant: str, v_cut: int):
    """The planted region: object 0 in the first ``v_cut`` view bins for
    ``noise``, all of object 0 for ``withhold`` and ``offset``."""
    if plant == "noise":
        return (obj_id == HARD_OBJ) & (persp_id < v_cut)
    return obj_id == HARD_OBJ


def corrupt(batch: Dict, v_cut: int, joints_noise: torch.Tensor,
            corners_noise: torch.Tensor) -> Dict:
    """``corrupt_wrap``'s plant on one synth batch: the region's rows get
    the given noise (already scaled by sigma) added to their 3D targets."""
    hard = region_mask(batch[SynthQueries.OBJ_ID], batch[SynthQueries.PERSP_ID], "noise", v_cut)
    m = hard[:, None, None].float()
    batch = dict(batch)
    batch[Queries.JOINTS_3D] = batch[Queries.JOINTS_3D] + joints_noise * m
    batch[Queries.CORNERS_3D] = batch[Queries.CORNERS_3D] + corners_noise * m
    return batch


def offset_vector(offset_m: float, device) -> torch.Tensor:
    """The fixed (3,) offset of length ``offset_m``, made once on ``device``."""
    return torch.tensor(OFFSET_DIR, device=device) * offset_m


def offset(batch: Dict, off: torch.Tensor) -> Dict:
    """``offset_wrap``'s plant: object 0's joint and corner targets moved by
    the fixed vector ``off`` (``offset_vector``)."""
    m = (batch[SynthQueries.OBJ_ID] == HARD_OBJ).float()[:, None, None]
    batch = dict(batch)
    batch[Queries.JOINTS_3D] = batch[Queries.JOINTS_3D] + off * m
    batch[Queries.CORNERS_3D] = batch[Queries.CORNERS_3D] + off * m
    return batch


class PlantedSynth:
    """A ``SynthBatch`` with a plant applied to every batch it renders; its
    draws and other attributes are the wrapped one's."""

    def __init__(self, synth_fn, plant: str, v_cut: int, sigma: float, seed: int, device):
        self.inner, self.plant, self.v_cut, self.sigma = synth_fn, plant, v_cut, sigma
        self.off = offset_vector(sigma, device)
        self.noise = torch.Generator(device=device)
        self.noise.manual_seed(seed + NOISE_SEED_OFFSET)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, gen, idx, draws) -> Dict:
        batch = self.inner(gen, idx, draws)
        if self.plant == "offset":
            return offset(batch, self.off)
        j, c = batch[Queries.JOINTS_3D], batch[Queries.CORNERS_3D]
        jn = torch.randn(j.shape, generator=self.noise, device=j.device) * self.sigma
        cn = torch.randn(c.shape, generator=self.noise, device=c.device) * self.sigma
        return corrupt(batch, self.v_cut, jn, cn)


def region_grid(shape: Sequence[int], plant: str) -> np.ndarray:
    """(O, V, G) bool: the planted region over the CCV space."""
    O, V, G = shape
    oid, vid = np.meshgrid(np.arange(O), np.arange(V), indexing="ij")
    region = np.zeros((O, V, G), bool)
    region[region_mask(oid, vid, plant, V // 4)] = True
    return region


def run_variant(method: str, seed: int, epochs: int, sigma: float, cfg_base: Dict,
                plant: str = "noise", release_epoch: int = 0, val_len: Optional[int] = None,
                dist_thresholds: Optional[Sequence[float]] = None, device=None) -> Dict:
    cfg = config_for(cfg_base, method, seed, epochs)
    if val_len:
        cfg["MANAGER"]["VAL_LEN"] = int(val_len)
    if dist_thresholds:
        cfg["MANAGER"]["DIST_THRESHOLD"] = {"LOWER": float(dist_thresholds[0]),
                                            "UPPER": float(dist_thresholds[1])}
    run = Variant(cfg, seed, epochs, resolve_device(device))
    loader = run.loader
    shape = loader.ccv.shape
    if plant in ("noise", "offset"):  # train AND val synthesis carry the plant
        loader.synth_batch_fn = PlantedSynth(loader.synth_batch_fn, plant, shape[1] // 4,
                                             sigma, seed, run.device)

    region = region_grid(shape, plant)
    not_black = ~loader.ccv.blacklist_map.cpu().numpy().astype(bool)
    region_frac_uniform = float((region & not_black).sum() / not_black.sum())
    region_t = torch.from_numpy(region).to(run.device)
    t0 = time.time()
    val_region, val_rest, val_epochs = [], [], []
    region_draw_frac = []  # the train draw's share in the region, after release
    for epoch in range(epochs):
        if plant == "withhold" and epoch < release_epoch:
            # mask the DRAW only: the map itself stays, so the uniform control
            # recovers at release and mining keeps what val taught it
            saved = loader.ccv.sample_weight_map
            loader.ccv = loader.ccv._replace(
                sample_weight_map=torch.where(region_t, torch.zeros_like(saved), saved))
            loader.prepare()
            loader.ccv = loader.ccv._replace(sample_weight_map=saved)
        else:
            loader.prepare()
            if plant in ("withhold", "offset"):
                region_draw_frac.append(float(
                    (loader.generated.obj_id == HARD_OBJ).float().mean()))
        run.train_epoch(epoch)
        if run.val_epoch(epoch) is not None:
            vmap, seen = run.val_maps()
            if (seen & region).any() and (seen & ~region).any():
                val_region.append(float(vmap[seen & region].mean()))
                val_rest.append(float(vmap[seen & ~region].mean()))
                val_epochs.append(epoch)
        loader.step_eval(epoch, run.evaluator)

    w = loader.ccv.sample_weight_map.cpu().numpy() * not_black
    region_mass = float(w[region].sum() / max(w.sum(), 1e-9))
    # endpoint: the mean of the last 3 post-release val readings (withhold,
    # offset: the region's EPE falls as it is learned), or of all (noise)
    if plant in ("withhold", "offset"):
        post = [v for v, e in zip(val_region, val_epochs) if e >= release_epoch]
        post_rest = [v for v, e in zip(val_rest, val_epochs) if e >= release_epoch]
        end_region = float(np.mean(post[-3:])) if post else None
        end_rest = float(np.mean(post_rest[-3:])) if post_rest else None
    else:
        end_region = float(np.mean(val_region)) if val_region else None
        end_rest = float(np.mean(val_rest)) if val_rest else None
    row = {
        "method": method, "seed": seed, "epochs": epochs, "plant": plant,
        "sigma_mm": sigma * 1e3 if plant in ("noise", "offset") else None,
        "release_epoch": release_epoch if plant == "withhold" else None,
        "train_s": round(time.time() - t0, 1),
        "region_frac_uniform": round(region_frac_uniform, 4),
        "region_weight_mass": round(region_mass, 4),
        "mass_ratio_vs_uniform": round(region_mass / region_frac_uniform, 3),
        "val_epe_region_mm": round(end_region, 1) if end_region else None,
        "val_epe_rest_mm": round(end_rest, 1) if end_rest else None,
        "region_draw_frac_post_release": (
            round(float(np.mean(region_draw_frac)), 4) if region_draw_frac else None),
        # method_3/4: the share of val-seen triplets solved below
        # DIST_THRESHOLD.LOWER at the last reweight (-1: not applicable)
        "dist_lower_ratio": round(loader.last_dist_lower_ratio, 4),
        "val_region_traj": [round(v, 1) for v in val_region],
        "val_epochs": val_epochs,
    }
    print(json.dumps(row), flush=True)
    return row


def ci95(xs):
    """(mean, half-width of the 95 % t interval) over the seeds."""
    xs = np.asarray(xs, np.float64)
    if xs.size < 2:
        return float(xs.mean()), 0.0
    t = {1: 12.71, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365}.get(xs.size - 1, 2.0)
    return float(xs.mean()), float(t * xs.std(ddof=1) / np.sqrt(xs.size))


def summary(rows: List[Dict], methods: List[str]) -> List[Dict]:
    """Per method the CIs over seeds, then the paired payoff of each method
    against the uniform control (positive: lower region EPE than uniform)."""
    out = []
    for m in methods:
        sel = [r for r in rows if r["method"] == m]
        mass_mu, mass_hw = ci95([r["region_weight_mass"] for r in sel])
        ratio_mu, ratio_hw = ci95([r["mass_ratio_vs_uniform"] for r in sel])
        reg = [r["val_epe_region_mm"] for r in sel if r["val_epe_region_mm"]]
        rest = [r["val_epe_rest_mm"] for r in sel if r["val_epe_rest_mm"]]
        out.append({
            "method": m, "n": len(sel),
            "region_weight_mass": f"{mass_mu:.4f} +- {mass_hw:.4f}",
            "mass_ratio_vs_uniform": f"{ratio_mu:.3f} +- {ratio_hw:.3f}",
            "val_epe_region_mm": round(float(np.mean(reg)), 1) if reg else None,
            "val_epe_rest_mm": round(float(np.mean(rest)), 1) if rest else None,
        })
    uni = {r["seed"]: r for r in rows if r["method"] == "uniform"}
    for m in methods:
        if m == "uniform":
            continue
        deltas = [uni[r["seed"]]["val_epe_region_mm"] - r["val_epe_region_mm"]
                  for r in rows if r["method"] == m and r["seed"] in uni
                  and r["val_epe_region_mm"] and uni[r["seed"]]["val_epe_region_mm"]]
        if deltas:
            mu, hw = ci95(deltas)
            out.append({"paired_delta": f"uniform - {m}", "n": len(deltas),
                        "region_epe_improvement_mm": f"{mu:.1f} +- {hw:.1f}",
                        "ci_excludes_zero": bool(len(deltas) >= 2
                                                 and (mu - hw > 0 or mu + hw < 0))})
    return out


def main(argv=None) -> Dict:
    """-> {"rows": one dict per run, "summary": the summary lines}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--methods", nargs="+", default=["method_1", "uniform"])
    ap.add_argument("--plant", choices=["noise", "withhold", "offset"], default="noise")
    ap.add_argument("--release_frac", type=float, default=1.0 / 3.0,
                    help="withhold: fraction of epochs before release")
    ap.add_argument("--val_len", type=int, default=None,
                    help="override MANAGER.VAL_LEN (withhold wants denser val coverage)")
    ap.add_argument("--dist_thresholds", type=float, nargs=2, default=None,
                    metavar=("LOWER", "UPPER"), help="override DIST_THRESHOLD (mm)")
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    arg = ap.parse_args(argv)

    release_epoch = int(round(arg.epochs * arg.release_frac)) if arg.plant == "withhold" else 0
    cfg = load_config(arg.cfg)
    rows = []
    for seed in arg.seeds:
        for method in arg.methods:
            logger.info(f"=== planted mining ({arg.plant}): {method} seed {seed} ===")
            rows.append(run_variant(method, seed, arg.epochs, arg.sigma, cfg, plant=arg.plant,
                                    release_epoch=release_epoch, val_len=arg.val_len,
                                    dist_thresholds=arg.dist_thresholds, device=arg.device))
    print("=== SUMMARY (95% CI over seeds) ===")
    lines = summary(rows, arg.methods)
    for line in lines:
        print(json.dumps(line))
    return {"rows": rows, "summary": lines}


if __name__ == "__main__":
    main()
