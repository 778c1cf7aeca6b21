#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``artiboost_torch``) on one GPU.

Phases, each fatal on failure:
  1. device line (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel: ``artiboost_torch/csrc/raster.cu`` holds the
     three raster kernels (uv B1, Gouraud rgb B2, x-binned Gouraud B3);
     ptxas registers, spills and shared memory of each, and from
     ``cuobjdump -sass`` each kernel's shared loads against its float adds
     and multiplies, in the kernel and in its innermost loop of float work;
  3. each kernel against its plain PyTorch twin on the card, bit for bit:
     the seeded scenes of ``artiboost_torch/ops/raster_scenes.py`` (random
     triangles at F = 60 and F = 700, invalid faces, a two-triangle depth
     tie) with back-face culling off and on, B1 and B2, B3 at (xbin_w,
     tile_rows) = (16, 8), (8, 4), (16, 5) and (32, 8); B3 on the parity
     gate's binned scene at its (32, 8); the uv kernel on one val batch of
     the main path (B = 128 at 112x112); the rgb kernel and B3 at (64, 8),
     (64, 16), (128, 16) and (128, 32) (4096 pixels a tile) on one
     SyntheticHO render chunk at full width (B = 16 at 512x512, hand plus an
     object of up to 1024 faces), B3 also against B2 there (depth within
     1e-6; colour equal but at depth-key ties, which are counted). Kernel
     times (CUDA events over a CUDA graph of 50 launches, so the wrapper's
     host work is not timed), plain times and bounds at those shapes. The
     bound is the larger of the bytes (the rows the kernel reads of every
     valid face and the range table, once, and 16 B written a pixel, at
     3.35 TB/s; ``raster_measure.raster_work``) and the operations (pixel x
     face-box pairs x 25, at 67 TFLOP/s FP32). Beside it: the time of
     zeroing the kernel's outputs (the writes alone), the kernel's time with
     every face invalid (nothing staged or scanned) and the face
     evaluations per pixel that the kernel's tables leave;
  4. the val-and-mining slice at full width (config
     ho3dv2_clasbased_artiboost.yaml: ResNet34 in bfloat16, 224x224, batch
     128, CCV 4 x 288 x 50, method_1, the hand_obj refiner with ITERS 3
     from assets/refinenet_tpu.npz; VAL_LEN 8 x 128) for 2 epochs without
     the train pass; refined poses finite and moved off the scrambled ones;
  5. the train pass at full width through ``artiboost_torch.train.run``:
     the same config with DATASET.TRAIN = SyntheticHO (RAW_SIZE 512,
     N_SAMPLES 640, so 80 real + 48 synth per batch and 8 steps per
     epoch), VAL_LEN 2 x 128, 2 epochs, EVAL_FREQ 1 / VAL_START_EPOCH 0;
     the refiner checked as in 4; then the KEY_VALID masks of a mixed batch
     whose real half lacks the MANO keys;
  6. the parity gate ``artiboost_torch.chip_parity.run_all()`` (the path
     that runs B3), its summary printed;
  7. checkpoint and resume: the train pass of 5 at a smaller depth
     (SyntheticHO N_SAMPLES 160, VAL_LEN 128) checkpoints epoch 1 into a
     temporary experiment directory; a fresh ``run`` resumes it, the
     restored model, optimizer, schedule and ArtiBoost state are held
     bit-equal to what was saved, and epoch 2 runs.
Every launch counter is zeroed just before phases 4, 5, 6 and 7 and read
just after each. TF32 is off. The lines before the last: the kernel table
as one JSON object (B1 and B2 launches from phase 5, B3 launches from phase
6) and the card's name and power limit; the last line: the ok JSON.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)
"""
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # non-tensor FP32, H100 SXM data sheet
RASTER_OPS_PER_LANE = 25        # pass-1 operations per (pixel, face)
# (xbin_w, tile_rows). B3 scans 16 x 16 windows of each band, whatever the
# tile, which fixes only the twin's range table: the check tiles take bands
# narrower than a window (8, 5) and not a multiple of it; the full-width
# tiles are those of the JAX package's users, and one of 4096 pixels.
BINNED_CHECK_TILES = ((16, 8), (8, 4), (16, 5), (32, 8))
BINNED_FULL_TILES = ((64, 8), (64, 16), (128, 16), (128, 32))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean ms of fn() over reps calls, by CUDA events. With ``graph`` the
    calls are captured once in a CUDA graph and the replay is timed, so a
    kernel faster than its wrapper's host work is timed on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel, finish, inp, torch):
    """Kernel vs its plain twin on one prepared input: -> (max abs err,
    equal)."""
    k = finish(inp, *kernel(inp))
    p = finish(inp, *kernel.twin(*inp.twin_args()))
    torch.cuda.synchronize()
    err, equal = 0.0, True
    for a, b in zip(k, p):
        equal &= bool(torch.equal(a, b))
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err, equal


def capture(module, name, fn):
    """Run fn() with module.name wrapped; -> (args, kwargs) of its first call."""
    orig, seen = getattr(module, name), {}

    def wrapper(*args, **kw):
        seen.setdefault("call", (args, kw))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return seen["call"]


def spy_refiners(loader_module):
    """Wrap every refiner the loader builds from now on: -> (records of
    (scrambled pose, scrambled tsl, refined pose, refined tsl), restore)."""
    records, orig = [], loader_module.build_refiner

    def build(*args, **kw):
        inner = orig(*args, **kw)

        def refine(feed, obj_verts=None, obj_valid=None):
            out = inner(feed, obj_verts, obj_valid)
            records.append((feed["hand_pose"], feed["hand_tsl"], out["hand_pose"],
                            out["hand_tsl"]))
            return out

        return refine

    loader_module.build_refiner = build
    return records, lambda: setattr(loader_module, "build_refiner", orig)


def check_refined(records, label: str, torch):
    """Every refined pose finite and moved off its scrambled input."""
    check(bool(records), f"{label}: the refiner never ran")
    pose0, tsl0, pose1, tsl1 = (torch.cat([r[i] for r in records]) for i in range(4))
    check(bool(torch.isfinite(pose1).all() and torch.isfinite(tsl1).all()),
          f"{label}: non-finite refined poses")
    d_pose = (pose1 - pose0).abs().amax(-1)
    d_tsl = (tsl1 - tsl0).norm(dim=-1)
    moved = (d_pose > 0) | (d_tsl > 0)
    check(bool(moved.all()), f"{label}: {int((~moved).sum())} of {moved.numel()} refined "
          "poses equal their scrambled input")
    print(f"{label}: hand_obj refiner (ITERS 3) ran {len(records)} times on {moved.numel()} "
          f"poses, all finite and moved: mean max |d pose| {float(d_pose.mean()):.4f} rad, "
          f"mean |d tsl| {float(d_tsl.mean()) * 1e3:.3f} mm", flush=True)


def sass_lines(path) -> list:
    """Per kernel of the library at ``path``, from ``cuobjdump -sass``: its
    shared loads, float adds, multiplies and fused multiply-adds, in all and
    in its innermost loop of float work (``raster_measure.sass_counts``)."""
    from artiboost_torch.ops.raster_measure import sass_counts

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    check(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")

    def mix(n):
        lds = sum(v for k, v in n.items() if k.startswith("LDS"))
        return (f"LDS {lds} ({n['LDS.128']} of 128 bits), FADD {n['FADD']}, FMUL {n['FMUL']}, "
                f"FFMA {n['FFMA']}, BAR {n['BAR']}")

    lines = []
    for fn, c in sass_counts(res.stdout).items():
        name = next((k for k in ("raster_uv_kernel", "raster_rgb_kernel",
                                 "raster_rgb_binned_kernel") if k in fn), fn)  # unmangled
        lines.append(f"  sass {name}: {sum(c['all'].values())} instructions: {mix(c['all'])}; "
                     f"innermost loop of float work, {c['loop_len']} instructions: "
                     f"{mix(c['loop'])}")
    return lines


def timing(kernel, inp, reps_plain: int, card: str, torch):
    """Kernel time (a CUDA graph of 50 launches), the time of zeroing its
    outputs (the writes alone), its time with every face invalid (tables
    read, no face staged or scanned, background written), the twin's time
    (host loop, ``reps_plain`` calls) and the bound at this input."""
    from artiboost_torch.ops.raster_measure import face_evaluations, raster_work
    from artiboost_torch.ops.rasterizer_cuda import RASTER_TILE, kernel_tables

    ms = cuda_ms(lambda: kernel(inp), 50, graph=True)
    outs = kernel(inp)
    fill_ms = cuda_ms(lambda: [t.zero_() for t in outs], 50, graph=True)  # the writes alone
    blank = inp._replace(geom=inp.geom.clone())
    blank.geom[..., 4, :] = -1e30  # ec0' of an invalid face
    blank = kernel_tables(blank)
    empty_ms = cuda_ms(lambda: kernel(blank), 50, graph=True)
    del blank
    twin_args = inp.twin_args()
    plain_ms = cuda_ms(lambda: kernel.twin(*twin_args), reps_plain)
    B, n_pix = inp.geom.shape[0], inp.height * inp.width
    read, written, pairs = raster_work(inp, 4 if kernel.name == "raster_uv" else 3)
    t_bytes = (read + written) / H100_BYTES_PER_S
    t_ops = pairs * RASTER_OPS_PER_LANE / H100_FP32_OPS_PER_S
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    evals = face_evaluations(inp)
    tile = inp.tile[::-1] or (RASTER_TILE, RASTER_TILE)
    print(f"{kernel.name} timing ({card}): B={B} {inp.height}x{inp.width} "
          f"F={inp.order.shape[-1]} tile {tile[0]}x{tile[1]}: kernel {ms:.4f} ms, "
          f"zeroing its outputs {fill_ms:.4f} ms, with every face invalid {empty_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by "
          f"{bound_by} ({bound_ms / ms:.1%} of it reached; {read} B read, {written} B written, "
          f"{pairs} pixel x face-box pairs = {pairs / (B * n_pix):.3f} a pixel); "
          f"{evals / (B * n_pix):.3f} face evaluations/pixel", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def full_width_config():
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["TRAIN"]["EVAL_FREQ"] = 1
    cfg["TRAIN"]["VAL_START_EPOCH"] = 0
    return cfg


def checkpoint_resume(cfg, init, device) -> str:
    """Phase 7: ``run`` checkpoints epoch 1 into a temporary experiment
    directory; a fresh ``run`` resumes it, and what the resume restored
    (model, optimizer, schedule, ArtiBoost state) is held bit-equal to what
    the first run ended with; then epoch 2 runs. -> a summary line."""
    import torch

    from artiboost_torch.train import run
    from artiboost_torch.utils.recorder import Recorder

    class ResumeProbe(Recorder):
        """Keeps copies of what a resume restored, before training goes on."""

        def resume_checkpoints(self, step, path=None):
            epoch = super().resume_checkpoints(step, path)
            self.restored = {"epoch": epoch, "step": step.step,
                             "model": copy.deepcopy(step.model.state_dict()),
                             "optimizer": copy.deepcopy(step.optimizer.state_dict())}
            return epoch

        def resume_artiboost_state(self):
            self.artiboost = super().resume_artiboost_state()
            return self.artiboost

    root = tempfile.mkdtemp(prefix="chip_smoke_exp_")
    t0 = time.perf_counter()
    try:
        rec = Recorder("smoke", cfg, root=root)
        try:
            first = run(cfg, epochs=1, device=device, model_state=init, recorder=rec)
        finally:
            rec.close()
        saved = {"step": first["step"].step,
                 "model": copy.deepcopy(first["model"].state_dict()),
                 "optimizer": copy.deepcopy(first["step"].optimizer.state_dict()),
                 "artiboost": first["loader"].state_dict()}
        del first
        probe = ResumeProbe("smoke", cfg, root=root, resume_path=rec.dump_path)
        try:
            second = run(cfg, epochs=2, device=device, model_state=init, recorder=probe,
                         resume=True)
        finally:
            probe.close()
        got = probe.restored
        check(got["epoch"] == 1 and got["step"] == saved["step"] > 0,
              f"resumed at epoch {got['epoch']} step {got['step']}, saved step {saved['step']}")
        bad = [k for k, v in saved["model"].items() if not torch.equal(got["model"][k], v)]
        check(not bad, f"model tensors not restored bit-equal: {bad[:5]}")
        want_opt, got_opt = saved["optimizer"], got["optimizer"]
        check(want_opt["param_groups"] == got_opt["param_groups"]
              and all(torch.equal(got_opt["state"][i][k], v)
                      for i, st in want_opt["state"].items() for k, v in st.items()),
              "optimizer state not restored bit-equal")
        ab = probe.artiboost
        check(ab["use_synth"] == saved["artiboost"]["use_synth"]
              and all(bool((ab[k] == saved["artiboost"][k]).all()) for k in (
                  "sample_weight_map", "occurrence_map", "epoch_idx", "rng_state")),
              "ArtiBoost state not restored bit-equal")
        hist = second["history"]
        check([r["epoch"] for r in hist] == [1], f"the resumed run ran epochs "
              f"{[r['epoch'] for r in hist]}, expected [1]")
        check(all(math.isfinite(v) for v in hist[0]["train"]["final_loss"]),
              "non-finite loss after the resume")
        latest = torch.load(os.path.join(probe.ckpt_dir, "latest.pt"), map_location="cpu",
                            weights_only=True)
        check(latest["epoch"] == 2, f"the last checkpoint holds epoch {latest['epoch']}")
        files = sorted(os.listdir(probe.ckpt_dir))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (f"epoch 1 saved and resumed bit-equal (model {len(saved['model'])} tensors, "
            f"optimizer, schedule step {saved['step']}, ArtiBoost maps and generator), epoch 2 "
            f"run, checkpoints {files}; {time.perf_counter() - t0:.2f} s for both runs")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "artiboost_torch", "csrc")):
        fail(f"{REPO} does not hold the artiboost_torch package")
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import logging

    from artiboost_torch.utils.misc import LOG_FORMAT

    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT, datefmt="%H:%M:%S")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from artiboost_torch import chip_parity
    from artiboost_torch.artiboost import loader as loader_module
    from artiboost_torch.artiboost import renderer
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.datasets.synthetic import build_dataset
    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.ops.raster_scenes import raster_check_scenes, rgb_attrs
    from artiboost_torch.ops.cuda_build import BUILD_DIR
    from artiboost_torch.ops.rasterizer_cuda import (
        finish_rgb_raster,
        finish_uv_raster,
        prepare_raster,
        prepare_raster_binned,
        raster_rgb,
        raster_rgb_binned,
        raster_uv,
    )
    from artiboost_torch.parallel.train_state import eval_step
    from artiboost_torch.train import StageTimer, run, slice_config, val_epoch
    from artiboost_torch.utils.batching import KEY_VALID, union_concat

    all_kernels = (raster_uv, raster_rgb, raster_rgb_binned)

    def zero_counts():
        for k in all_kernels:
            k.launches = 0

    def read_counts():
        return {k.name: k.launches for k in all_kernels}

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    dev = torch.device("cuda")

    # ---- 2. build ----
    t0 = time.perf_counter()
    raster_uv.build()
    print(f"build: {raster_uv.library.source} (raster_uv, raster_rgb, raster_rgb_binned) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in raster_uv.build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "smem" in line):
            print(f"  ptxas: {line.strip()}")
    for line in sass_lines(BUILD_DIR / "libraster.so"):
        print(line, flush=True)

    # ---- 3. kernels against their plain twins ----
    kernels = {k.name: {"kernel": k, "max_abs_err": 0.0} for k in all_kernels}
    finish = {"raster_uv": finish_uv_raster, "raster_rgb": finish_rgb_raster,
              "raster_rgb_binned": finish_rgb_raster}

    def hold(kernel, inp, label):
        err, equal = compare(kernel, finish[kernel.name], inp, torch)
        kernels[kernel.name]["max_abs_err"] = max(kernels[kernel.name]["max_abs_err"], err)
        print(f"{kernel.name} {label}: bit-equal={equal} max_abs_err={err}", flush=True)
        check(equal, f"{kernel.name} differs from its plain twin on {label}")

    for name, sc in raster_check_scenes().items():
        t = {k: torch.from_numpy(sc[k]).to(dev) for k in ("verts", "attrs", "faces", "valid")}
        rgb = torch.from_numpy(rgb_attrs(sc)).to(dev)
        for cull in (False, True):
            for kernel, attrs in ((raster_uv, t["attrs"]), (raster_rgb, rgb)):
                hold(kernel, prepare_raster(t["verts"], attrs, t["faces"], t["valid"], sc["H"],
                                            sc["W"], cull_backfaces=cull), f"{name} cull={cull}")
            for xbin_w, tile_rows in BINNED_CHECK_TILES:
                hold(raster_rgb_binned,
                     prepare_raster_binned(t["verts"], rgb, t["faces"], t["valid"], sc["H"],
                                           sc["W"], xbin_w, tile_rows, cull_backfaces=cull),
                     f"{name} cull={cull} tile {tile_rows}x{xbin_w}")
    # the parity gate's own binned input, at its launch configuration
    verts, attrs, faces, _ = chip_parity._scene(dev, seed=3)
    hold(raster_rgb_binned,
         prepare_raster_binned(verts, attrs, faces, None, chip_parity.H, chip_parity.W, 32, 8),
         f"parity-gate scene (seed 3, B=2 {chip_parity.H}x{chip_parity.W} F=160) tile 8x32")

    cfg = full_width_config()
    val_cfg = dict(cfg, MANAGER=dict(cfg["MANAGER"], VAL_LEN=8 * 128))
    probe = ArtiBoostLoader(cfg=slice_config(val_cfg), batch_size=128, seed=0, device=dev)
    probe.prepare_val()
    args, kw = capture(renderer, "rasterize_batch_uv", lambda: next(probe.iter_val()))
    inp = prepare_raster(*args, **kw)
    hold(raster_uv, inp, "main-path val batch")
    kernels["raster_uv"].update(timing(raster_uv, inp, 5, card, torch))
    del probe, inp

    synth_cfg = {"TYPE": "SyntheticHO", "DATA_SPLIT": "train", "AUG": True, "RAW_SIZE": 512,
                 "AUG_PARAM": {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}}
    args, kw = capture(renderer, "rasterize_batch_rgb", lambda: build_dataset(
        dict(synth_cfg, N_SAMPLES=16), cfg["DATA_PRESET"], device=dev))
    inp = prepare_raster(*args, **kw)
    hold(raster_rgb, inp, "SyntheticHO chunk")
    kernels["raster_rgb"].update(timing(raster_rgb, inp, 3, card, torch))
    chunk = f"SyntheticHO chunk B={inp.geom.shape[0]} {inp.height}x{inp.width}"
    rgb_1d, depth_1d = finish_rgb_raster(inp, *raster_rgb(inp))
    del inp
    for xbin_w, tile_rows in BINNED_FULL_TILES:
        tile = f"tile {tile_rows}x{xbin_w}"
        binp = prepare_raster_binned(*args, xbin_w=xbin_w, tile_rows=tile_rows, **kw)
        hold(raster_rgb_binned, binp, f"{chunk} {tile}")
        rgb_b, depth_b = finish_rgb_raster(binp, *raster_rgb_binned(binp))
        # The per-band sort gives a face another chunk and lane, so where two
        # faces tie on the truncated depth key the lane order can hand the
        # pixel to the other face: depth stays bit-equal, the colour may not.
        depth_err = float((depth_b - depth_1d).abs().max())
        rgb_diff = (rgb_b != rgb_1d).any(-1)
        n_tie = int((rgb_diff & (depth_b == depth_1d)).sum())
        n_diff = int(((depth_b != depth_1d) | rgb_diff).sum())
        rgb_err = float((rgb_b - rgb_1d).abs().max())
        print(f"raster_rgb_binned {chunk} {tile} against raster_rgb: depth max_abs_err="
              f"{depth_err}, rgb max_abs_err={rgb_err}; {n_diff} of {depth_b.numel()} pixels "
              f"differ at all, {n_tie} of them depth-key ties", flush=True)
        check(depth_err <= 1e-6 and int(rgb_diff.sum()) == n_tie
              and n_tie <= 1e-4 * depth_b.numel(),
              f"raster_rgb_binned {tile} departs from raster_rgb: depth {depth_err}, "
              f"{int(rgb_diff.sum())} rgb pixels of which {n_tie} at depth ties")
        timed = timing(raster_rgb_binned, binp, 2, card, torch)
        if "ms" not in kernels["raster_rgb_binned"]:
            kernels["raster_rgb_binned"].update(timed)
        del binp, rgb_b, depth_b

    # ---- 4. the val-and-mining slice (no train pass), bf16 ----
    records4, restore = spy_refiners(loader_module)
    zero_counts()
    timer4 = StageTimer(dev)
    t0 = time.perf_counter()
    try:
        loader = ArtiBoostLoader(cfg=slice_config(val_cfg), batch_size=128, n_epochs=2,
                                 seed=1, device=dev)
    finally:
        restore()
    evaluator = build_evaluator(val_cfg["EVALUATOR"], device=dev)
    criterion = build_criterion(val_cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        arch = build_arch(val_cfg["ARCH"], val_cfg["DATA_PRESET"]).to(dev)
    check(arch.model_list[0].backbone.conv1.compute_dtype == torch.bfloat16,
          "ARCH.DTYPE bfloat16 is not applied")
    t = timer4.mark()
    loader.prepare()
    timer4.add("pose sweep", t)
    n_val = n_val_images = 0
    for epoch in range(2):
        t = timer4.mark()
        loader.prepare()
        loader.prepare_val()
        timer4.add("pose sweep", t)
        res = val_epoch(loader, arch, criterion, evaluator, timer4)
        n_val, n_val_images = n_val + res["batches"], n_val_images + res["images"]
        loader.step_eval(epoch, evaluator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches4 = read_counts()
    check(n_val == 16, f"expected 16 val batches, ran {n_val}")
    check(launches4 == {"raster_uv": n_val, "raster_rgb": 0, "raster_rgb_binned": 0},
          f"phase 4 launches {launches4}, expected {n_val} uv and no other")
    check_refined(records4, "val slice", torch)
    vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
    avg, seen = vm.get_averaged_maps()
    check(int(seen.sum()) > 0 and bool(torch.isfinite(avg[seen]).all()),
          "val EPE map is empty or not finite where seen")
    w = loader.ccv.sample_weight_map
    check(not bool(torch.all(w == 1.0)), "sample_weight_map did not change after step_eval")
    check(float(w.min()) >= 0.1 and float(w.max()) <= 10.0, "sample_weight_map left [0.1, 10]")
    val_s = sum(timer4.seconds[s] for s in ("synth batch", "forward", "metric+mining"))
    print(f"val slice ({card}): 2 epochs in {wall:.2f} s, {n_val_images} val images, "
          f"{n_val_images / val_s:.2f} img/s over the val pass (bf16); launches {launches4}; "
          f"{int(seen.sum())} triplets seen, mean EPE {float(avg[seen].mean()):.2f} mm",
          flush=True)
    for stage in ("pose sweep", "synth batch", "forward", "metric+mining"):
        n = max(timer4.calls[stage], 1)
        print(f"  stage {stage}: {timer4.seconds[stage] * 1e3 / n:.3f} ms per call over "
              f"{timer4.calls[stage]} calls")
    del loader, arch, evaluator, records4

    # ---- 5. the train pass at full width ----
    cfg["DATASET"]["TRAIN"] = dict(synth_cfg, N_SAMPLES=640)
    cfg["MANAGER"]["VAL_LEN"] = 2 * 128
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        init = build_arch(cfg["ARCH"], cfg["DATA_PRESET"]).model_list[0].state_dict()
    init = {k: v.clone() for k, v in init.items()}
    records5, restore = spy_refiners(loader_module)
    zero_counts()
    timer5 = StageTimer(dev)
    t0 = time.perf_counter()
    try:
        out = run(cfg, epochs=2, device="cuda", model_state=init, timer=timer5)
    finally:
        restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    hist, loader = out["history"], out["loader"]
    steps = sum(r["train"]["steps"] for r in hist)
    val_batches = sum(r.get("val", {}).get("batches", 0) for r in hist)
    check(loader._mixed_counts() == (80, 48) and len(loader) == 8,
          f"expected 80 real + 48 synth in 8 steps, got {loader._mixed_counts()} in {len(loader)}")
    check(steps == 16 and val_batches == 4, f"ran {steps} train steps and {val_batches} val batches")
    check(launches["raster_rgb"] == math.ceil(640 / 16),
          f"rgb raster launched {launches['raster_rgb']} times, expected 40")
    check(launches["raster_uv"] == steps + val_batches,
          f"uv raster launched {launches['raster_uv']} times, expected {steps + val_batches}")
    check(launches["raster_rgb_binned"] == 0, "the train pass launched the binned raster")
    check_refined(records5, "train slice", torch)
    losses = [v for r in hist for v in r["train"]["final_loss"]]
    check(all(math.isfinite(v) for v in losses), f"non-finite train loss: {losses}")
    for r in hist:
        for part in ("train", "val"):
            ms = r[part]["measures"]
            check(all(math.isfinite(v) for m in ms.values() for v in m.values()),
                  f"non-finite {part} measures in epoch {r['epoch']}: {ms}")
    model = out["model"].model_list[0]
    final = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    stats = [n for n in final if n.endswith(("running_mean", "running_var"))]
    still = [n for n in names + stats if torch.equal(final[n].cpu(), init[n])]
    check(not still, f"unchanged after training: {still}")
    w = loader.ccv.sample_weight_map
    check(not bool(torch.all(w == 1.0)), "sample_weight_map did not change after step_eval")
    check(float(w.min()) >= 0.1 and float(w.max()) <= 10.0, "sample_weight_map left [0.1, 10]")
    # The mixed batch: SyntheticHO carries the synth schema in full, so the
    # union needs no mask. A real half without MANO annotations (as HO3D's
    # test split has none) must get KEY_VALID masks that zero its rows in
    # the losses that read those keys.
    real, sidx = next(loader.iter_parts())
    synth = loader.synth_part(sidx)
    batch = union_concat([real, synth])
    check(set(batch) - {KEY_VALID} == set(real) | set(synth)
          and batch["image"].shape[0] == 128 and batch["image"].dtype == torch.float32,
          "the mixed batch is not the key union of its halves")
    check((KEY_VALID in batch) == (set(real) != set(synth)),
          f"KEY_VALID masks {sorted(batch.get(KEY_VALID, {}))} do not match the halves' keys")
    mano_keys = ("hand_pose", "hand_shape", "hand_verts_3d")
    masked = union_concat([{k: v for k, v in real.items() if k not in mano_keys}, synth])
    n_real = real["image"].shape[0]
    want = torch.cat([torch.zeros(n_real), torch.ones(128 - n_real)]).to(dev)
    check(sorted(masked.get(KEY_VALID, {})) == sorted(mano_keys)
          and all(torch.equal(masked[KEY_VALID][k], want) for k in mano_keys),
          "a real half without MANO keys did not get 0/1 KEY_VALID masks on them")
    _, masked_losses = eval_step(out["model"], out["step"].criterion, masked,
                                 loader.draws.loss(out["step"].criterion))
    check(all(bool(torch.isfinite(v)) for v in masked_losses.values()),
          f"non-finite losses on the masked batch: {masked_losses}")
    print(f"mixed batch: {len(real)} real keys, {len(synth)} synth keys, KEY_VALID masks on "
          f"{sorted(batch.get(KEY_VALID, {})) or 'no key'}; a real half without "
          f"{list(mano_keys)} gets masks on exactly those, losses finite; synth image "
          f"{synth['image'].dtype} promoted to {batch['image'].dtype}", flush=True)
    secs = timer5.seconds
    train_s = sum(r["train"]["seconds"] for r in hist)
    images = sum(r["train"]["images"] for r in hist)
    print(f"train slice ({card}): 2 epochs in {wall:.2f} s, {steps} steps of 128, "
          f"{images / train_s:.2f} train img/s over the train epochs ({train_s:.3f} s); "
          f"final_loss {losses[0]:.6f} -> {losses[-1]:.6f}; launches {launches}; weights "
          f"[{float(w.min()):.4f}, {float(w.max()):.4f}]", flush=True)
    for stage in ("dataset init", "pose sweep", "real batch", "synth batch", "train step",
                  "forward", "metric+mining"):
        n = max(timer5.calls[stage], 1)
        print(f"  stage {stage}: {secs[stage] * 1e3:.2f} ms total, "
              f"{secs[stage] * 1e3 / n:.3f} ms per call over {timer5.calls[stage]} calls")
    del out, loader, model, final, records5, real, synth, batch, masked

    # ---- 6. the on-chip parity gate (the path of B3) ----
    zero_counts()
    t0 = time.perf_counter()
    try:
        summary = chip_parity.run_all(device=dev)
    except chip_parity.ParityError as e:
        fail(f"chip_parity: {e}")
    torch.cuda.synchronize()
    launches6 = read_counts()
    check(all(n >= 1 for n in launches6.values()),
          f"chip_parity did not launch every kernel: {launches6}")
    print(f"chip parity ({card}): CHIP PARITY OK ({time.perf_counter() - t0:.1f}s): {summary}; "
          f"launches {launches6}", flush=True)

    # ---- 7. checkpoint and resume ----
    ckpt_cfg = copy.deepcopy(cfg)
    ckpt_cfg["DATASET"]["TRAIN"]["N_SAMPLES"] = 160
    ckpt_cfg["MANAGER"]["VAL_LEN"] = 128
    zero_counts()
    line = checkpoint_resume(ckpt_cfg, init, "cuda")
    print(f"checkpoint/resume ({card}): {line}; launches {read_counts()}", flush=True)

    rows = []
    for name, src_line, counts in (("raster_uv", 222, launches), ("raster_rgb", 201, launches),
                                   ("raster_rgb_binned", 272, launches6)):
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": "artiboost_torch/csrc/raster.cu",
                     "replaces": f"artiboost_tpu/ops/rasterizer_pallas.py:{src_line}",
                     "launches": counts[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
