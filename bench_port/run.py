"""The benchmark of the PyTorch/CUDA port (``artiboost_torch``): one cell,
one run. Usage, from the root of a checkout::

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``BENCHMARK.json`` lists the
cells (configuration, traffic, chips) and metrics;
``bench_port/configs/<config>.json`` holds the recipe as it runs,
``bench_port/traffic/<traffic>.json`` the traffic mix (the entry that
drives the window and the recipe keys it sets), ``bench_port/workloads/
<cell>.json`` the check's sizes and limits, ``bench_port/entries/<entry>.py``
the unit the window repeats, ``bench_port/reference/<ARCH.TYPE>.py`` the
architecture's plain reference (its weights from the seed, its training
step, its operation count) and ``bench_port/metrics/<metric>.py`` the
reader of each per-layer metric.

A run builds the recipe through the program's own builders (evaluator,
criterion, ``ArtiBoostLoader``, ``build_arch``, ``TrainStep``), with
weights made on the card from ``--seed``, warms the cell's shapes with a
short unit, then runs whole units (the pose sweep, the entry's epoch or
val sweep, the mining step) until ``--seconds`` have passed. ``--trace 1``
runs one unit under ``torch.profiler`` and reports the per-layer metrics
instead. Afterwards the reference checks what the timed path produced
(``bench_port/capture.py`` keeps it, ``bench_port/checks.py`` compares
it), and the last line of standard output is the result."""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "artiboost_tpu")


def process_start() -> float:
    """The wall-clock second this process started (from /proc), else the
    moment this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(name: str):
    """The module of ``bench_port/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}",
                                                  os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def load_module(kind: str, name: str):
    """``bench_port/<kind>/<name>.py`` as a module (an entry, an
    architecture's reference)."""
    spec = importlib.util.spec_from_file_location(f"bench_port.{kind}.{name.replace('.', '_')}",
                                                  os.path.join(BENCH, kind, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, cell_def: Optional[Dict] = None) -> Dict:
    """A cell as BENCHMARK.json lists it (or as ``cell_def`` gives it, for a
    cell not listed yet), with its traffic file (``traffic/<traffic>.json``)
    and its check's sizes and limits (``workloads/<name>.json``)."""
    cell = dict(cell_def or next(w for w in load_json(ROOT, "BENCHMARK.json")["workloads"]
                                 if w["name"] == name))
    cell["check"] = load_json(BENCH, "workloads", f"{name}.json")["check"]
    cell["mix"] = load_json(BENCH, "traffic", f"{cell['traffic']}.json")
    return cell


def recipe_for(cell: Dict, cfg: Dict, seed: int, overrides: Optional[Dict] = None) -> Dict:
    """The configuration's recipe with the cell's traffic in force: the
    traffic file's ``recipe`` keys, then ``overrides`` (dotted paths)."""
    r = copy.deepcopy(cfg["recipe"])
    r["TRAIN"]["MANUAL_SEED"] = seed
    for path, value in {**cell["mix"].get("recipe", {}), **(overrides or {})}.items():
        node = r
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
    return r


def plant(env, fault) -> None:
    """Faults of the program that any entry can have: an answer altered where
    it is made (the model's output bias), the gradient exchange left out, a
    refiner iteration left out of the pose sweep, the blur left out of the
    synthetic image."""
    import torch

    from artiboost_torch.parallel import mesh

    if fault == "perturbed_answer":
        with torch.no_grad():
            env.arch.model_list[0].hybrid_head.final_layer.bias[0::28].add_(0.5)
    if fault == "no_exchange":
        orig = mesh.all_reduce_grads
        mesh.all_reduce_grads = lambda params: None
        env.restore.append(lambda: setattr(mesh, "all_reduce_grads", orig))
    if fault == "refiner_short":
        from artiboost_torch.artiboost.refiner import build_refiner

        pg = env.loader.pose_generator
        rcfg = dict(env.recipe["MANAGER"]["REFINER"])
        rcfg["ITERS"] = int(rcfg.get("ITERS", 3)) - 1
        pg.refiner = build_refiner(rcfg, pg.mano_model, device=env.dev)
    if fault == "no_blur":
        sb = env.loader.synth_batch_fn
        sb.cfg = sb.cfg._replace(blur_max_sigma=0.0)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, cache: Optional[str] = None,
             asset_sizes: Optional[Dict] = None, variants=("program",), fault=None,
             t_start: Optional[float] = None, cell_def: Optional[Dict] = None) -> Optional[Dict]:
    """One run of a cell -> {"result": the result line, "readings": {variant:
    numbers}, ...}; under a process group every rank runs it and rank 0
    returns it (the others None). ``variants`` beyond "program" and
    ``fault`` serve the control readings and the tests."""
    import torch

    from bench_port import assets, checks
    from bench_port.capture import Captures

    dev = torch.device(device)
    if t_start is None:
        t_start = process_start() if dev.type == "cuda" else time.time()
    cell = find_cell(cell_name, cell_def)
    cfg = load_json(BENCH, "configs", f"{cell['config']}.json")
    cfg["assets"].update(asset_sizes or {})
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = load_module("entries", cell["mix"]["entry"])
    unknown = set(cell["mix"]) - entry.TRAFFIC
    if unknown:
        raise ValueError(f"traffic {cell['traffic']!r}: keys {sorted(unknown)} are not read")
    recipe = recipe_for(cell, cfg, seed, overrides)
    ref_model = load_module("reference", recipe["ARCH"]["TYPE"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks = [("start", t_start), ("imported", time.time())]
    asset_dir = assets.ensure_assets(cfg, cache or assets.CACHE)
    marks.append(("assets", time.time()))
    os.chdir(asset_dir)
    # tensorboard loads TensorFlow where that is installed, and TensorFlow
    # loads JAX: the summarizer writes through tensorboard's own stub instead
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))

    from artiboost_torch import train as T
    from artiboost_torch.artiboost import renderer
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.parallel import mesh
    from artiboost_torch.utils import profiling
    from artiboost_torch.utils.summarizer import NullSummarizer, Summarizer

    world, rank = mesh.world(), mesh.rank()
    marks.append(("program imported", time.time()))
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed % (2 ** 32))
    env = types.SimpleNamespace(
        recipe=recipe, cfg=cfg, traffic=cell["mix"], check=cell["check"], seed=seed, dev=dev,
        rng=rng, bs=int(recipe["TRAIN"]["BATCH_SIZE"]), fault=fault, restore=[],
        n_check=int(cell["check"].get("steps", 3)), ref_cache={}, details={},
        pipeline=bool(recipe["TRAIN"].get("PIPELINE_SYNTH", True)), step=None)
    env.cap = Captures(rng, env.check)
    data_preset = recipe["DATA_PRESET"]
    env.evaluator = build_evaluator(recipe.get("EVALUATOR", []), data_preset, device=dev)
    env.criterion = build_criterion(recipe)
    env.loader = entry.build_loader(env)
    env.w0 = ref_model.weights(recipe, seed, dev)
    marks.append(("loader built", time.time()))
    env.arch = build_arch(recipe["ARCH"], data_preset).to(dev)
    ref_model.load_into(env.arch, env.w0)
    env.timer = T.StageTimer(dev)
    summ_dir = tempfile.mkdtemp(prefix="bench_port_summary_")
    env.summarizer = Summarizer(summ_dir) if rank == 0 else NullSummarizer()
    marks.append(("model built", time.time()))
    orig_raster = renderer.rasterize_batch_uv

    def raster_hooked(vs, attrs, faces, face_valid, height, width, cull_backfaces=False):
        out = orig_raster(vs, attrs, faces, face_valid, height, width,
                          cull_backfaces=cull_backfaces)
        env.cap.raster_hook((vs, attrs, faces, face_valid, height, width, cull_backfaces), out)
        return out
    renderer.rasterize_batch_uv = raster_hooked
    env.restore.append(lambda: setattr(renderer, "rasterize_batch_uv", orig_raster))
    plant(env, fault)
    env.loader.pose_generator = env.cap.pose_hook(env.loader.pose_generator)
    env.loader.synth_batch_fn = env.cap.synth_hook(env.loader.synth_batch_fn)
    env.cap.mining_hook(env.loader)
    try:
        # ---- set-up: the first pose sweep and a short unit of the cell's own shapes ----
        entry.setup(env)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        env.timer.seconds.clear()
        env.timer.calls.clear()
        marks.append(("warmed up", time.time()))

        # ---- the window: whole units until --seconds have passed ----
        trace_dir = os.path.join(asset_dir, f"trace_rank{rank}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        units, sweeps, images, steps = 0, [], 0, 0
        trace_path, traced_images = None, 0
        t_win = time.time()
        win0 = time.perf_counter()
        while True:
            entry.arm(env)
            if trace:
                env.cap.traced_raster = []
                profiling.start_trace(trace_dir)
            with profiling.trace("bench/unit"):
                t0 = time.perf_counter()
                with profiling.trace(entry.SWEEP_RANGE):
                    swept = entry.sweep(env)
                if trace and dev.type == "cuda":
                    torch.cuda.synchronize()
                sweeps.append((time.perf_counter() - t0, int(swept.obj_id.shape[0])))
                out = entry.unit(env, units + 1)
                steps += out["steps"]
                t0 = env.timer.mark()
                env.loader.step_eval(units + 1, env.evaluator)
                env.timer.add("metric+mining", t0)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            images += out["images"]
            units += 1
            if trace:
                traced_images = out["images"]
                trace_path = profiling.stop_trace()
                break
            stop = torch.tensor([float(time.perf_counter() - win0 >= seconds)], device=dev)
            if bool(mesh.broadcast_(stop)[0] > 0):  # rank 0 decides for all
                break
        window = time.perf_counter() - win0
        setup_s = t_win - t_start
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if world > 1:
            peak = max(mesh.gather_objects(int(peak)))
        stages = {"seconds": dict(env.timer.seconds), "calls": dict(env.timer.calls)}
        final_losses = [float(v) for v in out.get("final_loss", [])]
        forbidden = forbidden_modules()

        # ---- per-layer metrics from the traced unit ----
        per_layer, device_extra, breakdown = {}, {}, None
        if trace:
            from bench_port.count import trace as tr
            from bench_port.count.raster_work import raster_work

            events = tr.load_events(trace_path)
            lo, hi = tr.window_of(events, "bench/unit")
            main_tid = next(e["tid"] for e in events if e.get("cat") == "user_annotation"
                            and e["name"] == "bench/unit")
            works = [raster_work(*a) for a in env.cap.traced_raster]
            env.cap.traced_raster = None
            ctx = {"kind": cell["mix"]["entry"], "events": events, "window_us": (lo, hi),
                   "main_tid": main_tid, "traced_images": traced_images, "timer": stages,
                   "sweeps": sweeps, "steps": steps, "raster_work": works,
                   "chips": int(cell["chips"]), "flops": ref_model.flops(recipe)}
            for m in bench["per_layer"] if rank == 0 else []:
                if cell_name not in m.get("workloads", [cell_name]):
                    continue
                value = load_reader(m["name"]).read(ctx)
                if value is not None:
                    per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
            busy = [tr.busy_us(events, lo, hi) / 1e6]
            if world > 1:  # the device's busy seconds averaged over the cards used
                busy = mesh.gather_objects(busy[0])
            device_extra = {"busy_s": sum(busy) / len(busy), "window_s": (hi - lo) / 1e6}
            breakdown = {"device_ops": tr.top_device_ops(events, lo, hi),
                         "idle_gaps": tr.idle_gaps(events, lo, hi, main_tid)}
            del events, ctx
            shutil.rmtree(trace_dir, ignore_errors=True)
    finally:
        for r in reversed(env.restore):
            r()
        env.summarizer.close()
        shutil.rmtree(summ_dir, ignore_errors=True)

    # ---- the check, once the program's state is freed ----
    if world > 1:
        entry.gather(env, mesh)
        if rank != 0:
            return None
    manager = recipe["MANAGER"]
    lod = getattr(env.loader.synth_batch_fn, "lod", None)
    lod = None if lod is None else {"hand_rep": lod.hand_rep, "obj_verts": lod.obj_verts}
    env.loader = env.arch = env.step = env.evaluator = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    data = checks.reference_data(asset_dir, recipe, dev)
    center = int(data_preset["CENTER_IDX"])
    lower, upper = (float(manager["WEIGHT_UPDATE"][k]) for k in ("LOWER", "UPPER"))
    readings = {}
    for variant in tuple(variants) + (("bf16",) if "bf16" not in variants else ()):
        nums = entry.check(env, variant, checks, ref_model)
        v = "control" if variant == "control" else "program"  # the stages checked alone
        rows = env.checked_batches
        # the rows a checked step or batch lacks of the traffic's batch size
        nums["rows_missing"] = float(max(env.bs - b["image"].shape[0] for b in rows))
        nums["raster_mismatch"] = checks.raster_mismatch(env.cap.synth["raster"], v)
        nums["mano_gap_mm"] = checks.mano_gap_mm(rows, data["mano"], center, v)
        nums["reweight_gap"] = checks.reweight_gap(env.cap.snap, lower, upper, v)
        nums["pose_gap_mm"] = checks.pose_gap_mm(env.cap.pose, data, recipe, v)
        nums.update(checks.synth_gaps(env.cap.synth, data, recipe, lod, v))
        readings[variant] = nums
    if world > 1:
        readings["program"]["rank_spread"] = env.rank_spread
    for nums in readings.values():  # gaps in multiples of what bfloat16 rounding alone gives
        nums.update({name: nums[k] / max(readings["bf16"][k], 1e-30)
                     for name, k in checks.VS_BF16.items() if k in nums})

    limits = cell["check"].get("limits", {})
    prog = readings["program"]
    compared = {k: (prog.get(k), limits[k]) for k in limits}
    ok = (not forbidden and all(checks.finite(v) for v, _ in compared.values())
          and all(v <= lim for v, lim in compared.values())
          and all(np.isfinite(final_losses)))
    e2e = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] == entry.RATE and cell_name in m.get("workloads", [cell_name]):
                e2e[entry.RATE] = {"value": images / window, "unit": m["unit"]}
        if cell_def is not None:  # a cell not listed yet reports its entry's rate
            e2e[entry.RATE] = {"value": images / window, "unit": "images/s"}
        e2e["setup_s"] = {"value": setup_s, "unit": "s"}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    dev_info.update(device_extra)
    result = {"correct": bool(ok), "attempted": int(steps),
              "failed": int(sum(not np.isfinite(x) for x in final_losses)),
              "metrics": per_layer if trace else e2e, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    setup_split = {b[0]: round(b[1] - a[1], 3) for a, b in zip(marks, marks[1:])}
    return {"result": result, "readings": readings, "details": env.details,
            "setup_split": setup_split, "forbidden": forbidden,
            "units": units, "window_s": window, "stages": stages}


def _rank_entry(rank: int, world: int, port: int, cell_name: str, seed: int, seconds: float,
                trace: bool, kw: Dict, results) -> None:
    """One rank of a cell on several cards: joins the process group, runs
    the cell on its card; rank 0 hands its result to the parent."""
    import torch

    from artiboost_torch.parallel import mesh

    device_type = torch.device(kw.get("device", "cuda")).type
    mesh.init_distributed(f"localhost:{port}", world, rank, device_type=device_type)
    try:
        device = f"cuda:{torch.cuda.current_device()}" if device_type == "cuda" else "cpu"
        out = run_cell(cell_name, seed, seconds, trace, **dict(kw, device=device))
        if rank == 0:
            results.put(out)
    finally:
        mesh.close()


def run_ranks(cell_name: str, seed: int, seconds: float, trace: bool, world: int,
              **kw) -> Dict:
    """A cell on ``world`` ranks, one process a card, joined over a free
    localhost port -> rank 0's result. A rank that fails ends the others."""
    import socket

    import torch.multiprocessing as mp

    from bench_port import assets

    cell = find_cell(cell_name, kw.get("cell_def"))
    cfg = load_json(BENCH, "configs", f"{cell['config']}.json")
    cfg["assets"].update(kw.get("asset_sizes") or {})
    assets.ensure_assets(cfg, kw.get("cache") or assets.CACHE)  # once, before the ranks read it
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, port, cell_name, seed, seconds,
                                                   trace, kw, results)) for r in range(world)]
    for p in procs:
        p.start()
    out = None
    try:
        while any(p.is_alive() for p in procs):
            while not results.empty():  # rank 0 blocks in put() until it is read
                out = results.get()
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        while not results.empty():
            out = results.get()
    finally:
        for p in procs:
            if p.is_alive() and any(q.exitcode not in (None, 0) for q in procs):
                p.terminate()
            p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad or out is None:
        raise RuntimeError(f"a rank failed (exit codes {[p.exitcode for p in procs]})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench_port: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if chips > 1:
        out = run_ranks(args.workload, args.seed, args.seconds, bool(args.trace), chips,
                        t_start=process_start())
    else:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"bench_port: {power_limit()}", file=sys.stderr)
    print(f"bench_port: set-up seconds by stage {json.dumps(out['setup_split'])}; "
          f"{out['units']} units in {out['window_s']:.3f} s", file=sys.stderr)
    for variant, detail in out["details"].items():
        print(f"bench_port: {variant} detail {json.dumps(detail)}", file=sys.stderr)
    forbidden = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if forbidden:
        print(f"bench_port: modules of JAX or the JAX package were loaded: {forbidden}",
              file=sys.stderr)
        return 3
    res = out["result"]
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
