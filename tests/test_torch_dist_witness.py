"""Witness runs for data parallelism on the card (the file holds no test,
so the suite runs none of it). From the repository root run

    python tests/test_torch_dist_witness.py [variant ...]

with variants among:

- ``faults``: ``chip_smoke.py`` phase 14's recipe (2 ranks on the one card
  against 1 process, ``chip_smoke.dp_readings``) as it is and with one
  fault planted at run time in each 2-rank run: ``bn_local`` (BatchNorm's
  statistics and their gradient sums over the rank's own rows),
  ``bn_backward_local`` (the forward's statistics global, the backward's
  sums the rank's own) and ``grad_sum`` (gradients summed over the ranks,
  not averaged). Prints each run's readings, whether they are within phase
  14's bounds, and whether the ranks stayed bit-equal. About 4 minutes on
  one card. ``faults_f32``: the same in float32 (phase 14 holds the
  gradients of its float32 run).
- ``seeds``: phase 14's recipe, 2 ranks against 1 process, at each
  TRAIN.MANUAL_SEED of SEEDS (1 is the released recipe's and the smoke's),
  each on the port's triplet draw and on ``torch.multinomial`` (the draw
  until ``ccv.sample_triplets_draws`` became an inverse CDF, planted as
  ``multinomial``): each run's first-step and last-step losses apart, then
  each sampler's readings in order. Four launches at a time on the card,
  about 15 minutes.
- ``blacklist``: the released recipe's CCV blacklist built 10 times on
  every visible card in one process and on the CPU in float64 (the map
  ``tests/test_torch_dist.py`` holds the CPU build to); prints whether all
  are the same bits, and the least distance to the threshold. Seconds.
- ``cache_race``: one process writes the blacklist cache 300 times while
  three read it as a starting rank does (``isfile``, then ``np.load``),
  first written in place (``np.save`` onto the path) and then as the
  loader writes it (``loader.write_npy``, renamed into place), in a
  temporary directory and in ``build/`` of the checkout; prints the
  readers' loads that raised, that returned another map and that returned
  the map. About a minute."""
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # chip_smoke and artiboost_torch, run as a script
FAULTS = ("none", "bn_local", "bn_backward_local", "grad_sum")
SEEDS = range(1, 9)
SAMPLERS = {"inverse_cdf": "none", "multinomial": "multinomial"}  # -> the plant
RACE_WRITES = 300


def released_blacklist(device):
    """The released recipe's CCV space (config/ho3dv2_clasbased_artiboost.yaml:
    4 objects, 12 x 24 views, 50 grasps) -> (the float32 map the loader
    builds on ``device``, the float64 one on the CPU, the least
    |dot_z - threshold| in float64)."""
    from artiboost_torch.artiboost.ccv import build_blacklist_map
    from artiboost_torch.artiboost.grasp_library import get_grasp_library
    from artiboost_torch.artiboost.view_engine import ViewEngineConfig, persp_rotmat_centers
    from artiboost_torch.utils.config import load_config
    from artiboost_torch.utils.transform import aa_to_rotmat

    mgr = load_config(str(REPO / "config" / "ho3dv2_clasbased_artiboost.yaml"))["MANAGER"]
    view = mgr["VIEW_ENGINE"]
    view_cfg = ViewEngineConfig(
        persp_u_bins=view["PERSP_U_BINS"], persp_theta_bins=view["PERSP_THETA_BINS"],
        camera_z_min=view["CAMERA_Z_RANGE"][0], camera_z_max=view["CAMERA_Z_RANGE"][1])
    objs, n_grasp = mgr["OBJ_ENGINE"]["OBJ"], mgr["GRASP_ENGINE"]["GRASP_NUM"]
    lib = get_grasp_library(objs, n_grasp, device=device)
    built = build_blacklist_map(lib.hand_pose, persp_rotmat_centers(view_cfg, device)).cpu()
    pose = get_grasp_library(objs, n_grasp, device="cpu").hand_pose.double()
    back = torch.tensor([1.0, 0.2, 0.0], dtype=torch.float64)
    back_world = torch.einsum("ogij,j->ogi", aa_to_rotmat(pose[..., :3]),
                              back / torch.linalg.norm(back))
    dot_z = torch.einsum("vji,ogj->ovgi", persp_rotmat_centers(view_cfg, "cpu").double(),
                         back_world)[..., 2]
    return built, (dot_z < -0.8).float(), float((dot_z + 0.8).abs().min())


def _plant(fault: str) -> None:
    """Plant ``fault`` in this process's modules."""
    from artiboost_torch.models import layers
    from artiboost_torch.parallel import mesh

    class _LocalSums:
        """BatchNorm's reductions over this rank's rows, scaled as if they
        were the global batch's."""
        world = staticmethod(mesh.world)

        @staticmethod
        def all_reduce_sum_(t):
            return t * mesh.world()

    if fault == "bn_local":
        layers.mesh = _LocalSums
    elif fault == "bn_backward_local":
        backward = layers._GlobalBatchNorm.backward

        def local_backward(ctx, *grads):
            layers.mesh = _LocalSums
            try:
                return backward(ctx, *grads)
            finally:
                layers.mesh = mesh

        layers._GlobalBatchNorm.backward = staticmethod(local_backward)
    elif fault == "multinomial":
        from artiboost_torch.artiboost import loader

        draws = loader.sample_triplets_draws

        def multinomial(space, generator, n, replace=True):
            if not replace:
                return draws(space, generator, n, replace)
            w = space.effective_weights().reshape(-1)
            logw = torch.log(torch.clamp_min(w, 1e-20))
            return torch.multinomial(torch.exp(logw - logw.max()), n, replacement=True,
                                     generator=generator)

        loader.sample_triplets_draws = multinomial
    elif fault == "grad_sum":
        mean = mesh.all_reduce_grads

        @torch.no_grad()
        def summed(params):
            mean(params)
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(mesh.world())

        mesh.all_reduce_grads = summed


def faults(card: str, dtype: str = "bfloat16") -> None:
    import chip_smoke
    import yaml

    tmp = tempfile.mkdtemp(prefix="dist_witness_")
    try:
        cfg_path = chip_smoke._dp_config(tmp)
        with open(cfg_path) as f:
            cfg = yaml.safe_load(f)
        cfg["ARCH"]["DTYPE"] = dtype
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        worker = [sys.executable, os.path.abspath(__file__), "--worker"]
        one = chip_smoke._dp_launch(1, tmp, "one", cfg=cfg_path)
        print(f"1 process, {dtype} ({card}): final_loss {one[0]['final_loss']}", flush=True)
        for fault in FAULTS:
            ranks = chip_smoke._dp_launch(2, tmp, fault, cfg=cfg_path, worker=worker + [fault])
            got = chip_smoke.dp_readings(ranks, one)
            equal = all(r["final"] == ranks[0]["final"] for r in ranks)
            held = (all(got[k] <= b for k, b in chip_smoke.DP_LOSS_RTOL.items()),
                    got["grad"] <= chip_smoke.DP_GRAD_RTOL)
            print(f"2 ranks, {dtype}, fault {fault} ({card}): final_loss "
                  f"{ranks[0]['final_loss']}; "
                  f"steps apart {got['steps']}; first step's gradients apart from one process's on "
                  f"the same batch {got['grad']!r} (one process's twice: {got['again']!r}); "
                  f"parameter gap {got['gap']!r}; same start {got['same_start']}; ranks "
                  f"bit-equal {equal}; within phase 14's loss bounds {chip_smoke.DP_LOSS_RTOL} "
                  f"and its float32 gradient bound {chip_smoke.DP_GRAD_RTOL}: {held}",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def seeds(card: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    import yaml

    from artiboost_torch.ops.rasterizer_cuda import raster_uv

    raster_uv.build()  # once, before the launches start together
    tmp = tempfile.mkdtemp(prefix="dist_witness_seeds_")
    worker = [sys.executable, os.path.abspath(__file__), "--worker"]

    def launch(job):
        sampler, seed, world = job
        d = os.path.join(tmp, f"{sampler}_{seed}_{world}")
        os.makedirs(d)
        cfg_path = chip_smoke._dp_config(d)
        with open(cfg_path) as f:
            cfg = yaml.safe_load(f)
        cfg["TRAIN"]["MANUAL_SEED"] = seed
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        return chip_smoke._dp_launch(world, d, "run", cfg=cfg_path,
                                     worker=worker + [SAMPLERS[sampler]])

    jobs = [(sampler, seed, world) for sampler in SAMPLERS for seed in SEEDS for world in (2, 1)]
    try:
        with ThreadPoolExecutor(4) as pool:
            records = dict(zip(jobs, pool.map(launch, jobs)))
        readings = {}
        for sampler in SAMPLERS:
            for seed in SEEDS:
                got = chip_smoke.dp_readings(records[sampler, seed, 2], records[sampler, seed, 1])
                readings[sampler, seed] = got
                print(f"seed {seed}, {sampler} ({card}): steps apart {got['steps']}; first "
                      f"{got['first']!r}, last {got['last']!r}; parameter gap {got['gap']!r}; "
                      f"same start {got['same_start']}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for sampler in SAMPLERS:
        for k in ("first", "last"):
            xs = sorted(readings[sampler, seed][k] for seed in SEEDS)
            print(f"{sampler}, {k} step over seeds {SEEDS.start}-{SEEDS.stop - 1} ({card}): "
                  f"{', '.join(f'{x:.3e}' for x in xs)}; median {xs[len(xs) // 2]:.3e}, largest "
                  f"{xs[-1]:.3e} (phase 14's bound {chip_smoke.DP_LOSS_RTOL[k]})", flush=True)


def blacklist(card: str) -> None:
    devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cpu"]
    maps, ref, margin = [], None, None
    for dev in devices:
        for _ in range(10):
            built, ref, margin = released_blacklist(dev)
            maps.append(built)
    same = all(torch.equal(m, maps[0]) for m in maps)
    print(f"blacklist ({card}): {len(maps)} builds on {devices}: all the same bits {same}, "
          f"equal to the float64 map {torch.equal(maps[0], ref)}; "
          f"{int(maps[0].sum())} of {maps[0].numel()} blacklisted; least "
          f"|dot_z - threshold| {margin!r}", flush=True)


def _race_writer(path: str, how: str, arr: np.ndarray, done) -> None:
    from artiboost_torch.artiboost.loader import write_npy

    for _ in range(RACE_WRITES):
        if how == "in place":
            np.save(path, arr)
        else:
            write_npy(path, arr)
    done.set()


def _race_reader(path: str, arr: np.ndarray, done, out) -> None:
    counts = {"raised": 0, "other map": 0, "the map": 0}
    while not done.is_set():
        if not os.path.isfile(path):
            continue
        try:
            got = np.load(path)
        except (ValueError, EOFError, OSError):
            counts["raised"] += 1
            continue
        counts["the map" if got.shape == arr.shape and np.array_equal(got, arr)
               else "other map"] += 1
    out.put(counts)


def cache_race(card: str) -> None:
    arr, _, _ = released_blacklist("cpu")
    arr = arr.numpy()
    ctx = mp.get_context("spawn")
    (REPO / "build").mkdir(exist_ok=True)
    for where in (tempfile.gettempdir(), str(REPO / "build")):
        for how in ("in place", "rename"):
            d = tempfile.mkdtemp(prefix="cache_race_", dir=where)
            path = os.path.join(d, "map.npy")
            done, out = ctx.Event(), ctx.Queue()
            readers = [ctx.Process(target=_race_reader, args=(path, arr, done, out))
                       for _ in range(3)]
            for p in readers:
                p.start()
            time.sleep(2)  # the readers are polling before the first write
            t0 = time.perf_counter()
            writer = ctx.Process(target=_race_writer, args=(path, how, arr, done))
            writer.start()
            writer.join(timeout=120)
            counts = [out.get(timeout=60) for _ in readers]
            for p in readers + [writer]:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
            total = {k: sum(c[k] for c in counts) for k in counts[0]}
            print(f"cache race ({card}), {how} under {where}: {RACE_WRITES} writes in "
                  f"{time.perf_counter() - t0:.2f} s; 3 readers' loads {total}", flush=True)
            shutil.rmtree(d, ignore_errors=True)


def main(names) -> None:
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        smi = ""
    card = ", ".join(sorted(set(smi.strip().splitlines()))) or "no card"
    for name in names:
        {"faults": faults, "faults_f32": lambda c: faults(c, "float32"), "seeds": seeds,
         "blacklist": blacklist,
         "cache_race": cache_race}[name](card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _plant(sys.argv[2])
        import chip_smoke

        chip_smoke.dp_worker(json.loads(sys.argv[3]))
    else:
        main(sys.argv[1:] or ["faults", "faults_f32", "blacklist", "cache_race"])
