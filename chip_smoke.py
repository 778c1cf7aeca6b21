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
     bit-equal to what was saved, and epoch 2 runs;
  8. the released entry point at full width: ``artiboost_torch.train.main``
     on config/ho3dv2_clasbased_artiboost.yaml with DATASET.TRAIN left as
     HO3D, whose data is absent, so it trains synth-only
     (CONFIG_LEN_TRAIN 1024: 8 steps of 128), DATASET.TEST a SyntheticHO
     split (RAW_SIZE 512, N_SAMPLES 200: a batch of 128 and one of 72
     padded to 128), VAL_LEN 2 x 128, EVAL_FREQ 1, VAL_START_EPOCH 0,
     2 epochs, ``--test_freq 1``, ``--profile_dir`` and ``--profile_steps
     6``; then ``--resume <dir> --evaluate``. It checks the synth-only
     fallback, the 2 + 1 TEST passes, every evaluation JSON (PCK
     ``auc_all`` in [0, 1], finite EPEs), the Vis2D images (6 x 224
     square), the TensorBoard tags, the trace and the launches (13 rgb for
     the TEST init, uv for every train step and val batch, no binned), and
     prints from the trace the device idle share, the train step's host and
     device time and ``prepare_raster``'s host time against B1's;
  9. the Reg recipe at full width: ``artiboost_torch.train.main`` on
     config/ho3dv2_regbased_artiboost.yaml (HOPRegNet: ResNet34 in
     bfloat16, 224x224, batch 128, ManoBranch with 15 PCA components,
     ManoLoss; CCV 4 x 288 x 50, the hand_obj refiner) with DATASET.TRAIN
     left as HO3D (absent: synth-only, CONFIG_LEN_TRAIN 512, 4 steps of 128),
     VAL_LEN 128, EVAL_FREQ 1, VAL_START_EPOCH 0, 2 epochs, DATASET.TEST a
     SyntheticHO split of 128 images (RAW_SIZE 512) and ``--test_freq 2``:
     10 uv, 8 rgb and 0 binned launches, finite MANO terms, ManoBranch and
     the object head moved, the weight map changed inside [0.1, 10], PCK
     ``auc_all`` in [0, 1];
 10. the symmetric DexYCB recipe (config/dexycb_clasbased_sym_artiboost.yaml:
     HybridBaseline, CCV 7 x 288 x 50, CENTER_IDX 9, SymCornerLoss, AR and
     ValMetricAR2) at phase 9's depth: the same launches, a finite
     ``sym_corners_3d_loss`` and ``val_mssd_mean``, each ``step_eval``
     moving weights only where both the EPE and the MSSD maps saw a
     triplet, the TEST pass's AR recalls in [0, 1], and the line saying
     that MODEL_INFO_PATH is absent and the symmetries are identity.
 11. the released recipe on real-layout data at full width: in a temporary
     working directory, HO3D's train (480 frames) and evaluation (160)
     splits at 640x480 with their frame lists, the recipe's four YCB meshes
     (3,072 vertices, MTL, 1024x1024 textures) and their supplementary
     meshes, 50 grasps per object, 64 backgrounds, 16 HTML hands and a
     torchvision-named ResNet34 (``artiboost_torch/datasets/layouts.py``);
     ``artiboost_torch.train.main`` on config/ho3dv2_clasbased_artiboost.yaml
     unchanged but DATA_ROOT, EVAL_FREQ 1 and VAL_START_EPOCH 0: 2 epochs of
     6 steps of 80 HO3D + 48 synth images, the released VAL_LEN's val sweep,
     ``--test_freq 1``, a trace of epoch 0 through step 6. It checks every
     batch's split, that each TEST pass covered every evaluation frame, the
     loaded assets (no stand-in warning; 2,048 vertices a mesh after
     decimation), the backbone equal to the file before the first step,
     finite losses, the reweight, and launches (uv for every train step and
     val batch, no rgb, no binned); it prints the real batch's host
     geometry and decode, upload+warp and the step's wait on the
     prefetcher, the stages, the trace's idle share, and B1 held against
     its twin and timed on a train batch at these assets (F, atlas). Its
     directory and last checkpoint are kept for phase 13.
 12. the synth options at full width: ``artiboost_torch.train.main`` on the
     released config, synth-only (CONFIG_LEN_TRAIN 512: 4 steps of 128,
     VAL_LEN 128, 1 epoch, no TEST pass), twice: with RENDERER.TEXTURED
     false, MOTION_BLUR 7 at MOTION_BLUR_PROB 0.5 and the random_2
     scrambler (5 rgb launches, no uv; one synth batch held bit-equal
     against B2's twin and timed; the blur changed the foreground of
     exactly the images its draw picked), then with BILINEAR and random_3
     (5 uv launches, no rgb); finite losses; per-stage ms and train img/s;
 13. the submission entry point: ``artiboost_torch.submit_reload.main`` on
     config_eval/eval_ho3dv2_clasbased_artiboost.yaml (ResNet34, 224x224,
     batch 128) with DATA_ROOT at phase 11's files, ``--reload`` of its
     last checkpoint, ``--submit_dump --postprocess_fit_mesh
     --postprocess_draw``: HO3D v2's 160 evaluation frames in a batch of
     128 and a tail padded from 32. It checks the Codalab JSON (160 joint
     lists of 21 x 3, 160 vert lists of 778 x 3) and its zip (one deflated
     member under the basename), the fitted meshes finite and nearer the
     predicted joints than IKNet's warm start, the two overlay PNGs, one B2
     launch an overlay tile (32), finite measures; the first tile's raster
     held against B2's twin and timed; it prints the eval pass's, the
     FittingUnit's and the draw's ms per batch of 128. Phase 13b runs the
     four other released evaluation configs (HOPRegNet on HO3D v2, the
     two HO3D v3 configs, DexYCB) the same way from a random init, with
     drawing, on phase 11's files and an HO3D v3 evaluation split and a
     DexYCB s0 test split of 128 frames each written beside them: each
     dump has a row a frame (``pred_dexycb.json`` for DexYCB, with an AR
     in [0, 1]) and each overlay tile launched B2 once.
 14. data parallelism at full width: the released Clas recipe through
     ``artiboost_torch.train.main``, synth-only (CONFIG_LEN_TRAIN 512: 4
     steps of a global batch of 128, VAL_LEN 128, 1 epoch), run by 2
     processes joined with ``--multihost --coordinator localhost:<port>
     --num_processes 2 --process_id r`` on the one card (gloo), then by 1
     process with ``--multihost`` (NCCL), then ``--resume`` of the 2-rank
     run by 2 processes, then the 2-rank run in float32. Each process is this script with ``--dp-worker`` and a
     timeout. It checks that parameters, BatchNorm buffers, Adam's moments,
     the CCV weight and occurrence maps and every draw are bit-equal across
     the ranks, that each rank launched B1 once a step and a val batch at
     B = 64 and that B1 is bit-equal to its twin on the first of them, that
     the losses are within DP_LOSS_RTOL of the 1-process run's and, in
     float32, the first step's gradients within DP_GRAD_RTOL of those one
     process computes from the same batch, that the 1-process run joined
     NCCL, and that the resume restored
     the saved state bit for bit on both ranks;
 15. the trainers: ``artiboost_torch.scripts.train_refiner`` (100 steps at
     --batch 256 --obj_points 2048) and ``train_iknet`` (200 steps), each
     writing its npz to a temporary directory: finite losses, the mean of
     the last 10 steps below that of the first 10, each npz loaded back in
     the port equal to the trained net; ms a step and the held-out figures.
 16. the pipelined train step: phase 8's run (synth-only, 2 epochs of 8
     steps of 128, VAL_LEN 2 x 128, a trace of epoch 0's steps 1-6) with
     TRAIN.PIPELINE_SYNTH true (the default) and false, neither taking a
     stage wait: each order's epoch-1 train img/s, its trace's idle share
     and step wall, host, wait and device ms, and its host waits a train
     step (sync debug mode over epoch 0's steps 2-6, by file:line); B1
     launched once a synth batch in each; the first two synth batches
     byte-equal; then, in a process of its own under cuDNN's and torch's
     deterministic algorithms, a pipelined and two unpipelined runs: the
     orders' per-step losses and weight maps bit-equal, or within the two
     unpipelined runs' spread; the pipelined run's waits a step at most
     ALLOWED_WAITS_PER_STEP;
 17. the mining scripts, short: ``scripts.mining_planted --plant noise``
     (1 seed, 2 epochs, method_1 and uniform) and ``scripts.mining_ab`` (1
     seed, 2 epochs, its three methods) on config/mining_ab.yaml: their
     JSON lines finite, uniform's mass ratio exactly 1.000, B1 launched.
Every launch counter is zeroed just before phases 4 to 11 and 13, each
run of phases 12, 13b and 16, phase 17 and, in its own process, each run
of phase 14, and read just after each. TF32 is off. The lines before the
last: the smoke's seconds, the kernel table as one JSON object (B1
launches from phases 8 to 12, 14, 16 (its pipelined run) and 17, the two
ranks' of phase 14 also apart, B2 from 8 to 13b and 17, summed and by
phase, B3 launches from phase 6) and the card's name and power limit; the
last line: the ok JSON.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)
       (``python3 chip_smoke.py --dp-worker <json>`` is phase 14's own process,
       ``--order-worker <json>`` phase 16's deterministic one;
       ``python3 chip_smoke.py --dp-cards`` runs phase 14's recipe one rank a
       card over every card of a machine of 2 or more, by NCCL)
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
from typing import Optional

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
# phase 14 (``dp_readings``): over N ranks against a 1-process run, the
# first and last steps' losses, relative. The recipe's bf16 gradients part
# from one process's on the same batch by a quarter to a half of their norm
# (convolutions and their weight gradients over 128 / N rows in place of
# 128), and the parameters' gap to a 1-process run is noise on the card
# (the refiner's and MANO's last bits move with the rows, the rasterizer
# flips edge pixels on them), so both are printed, not bounded; a float32
# run holds the first step's gradients against one process's on the same
# batch. The readings, and those of planted faults, are in PERF.md.
DP_LOSS_RTOL = {"first": 2e-3, "last": 5e-3}
DP_GRAD_RTOL = 0.025


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


def _union_ms(intervals, lo, hi) -> float:
    """ms covered by the union of (start, end) intervals (us) within [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_figures(path: str) -> dict:
    """A train run's figures from its Chrome trace, over train steps 1 to
    the last traced one (step 0 holds first-use costs): the device idle
    share (1 - the union of kernel, memcpy and memset intervals over the
    window's wall time); per step (a ``train#<n>`` range: with
    PIPELINE_SYNTH the render of step n+1 and the train step n) its wall
    time (from its start to the next step's), its host time (the range
    less the time the host waited in CUDA runtime calls that block:
    synchronizes, blocking copies), that wait, and the device's busy time
    (the window's over its steps); the host time in
    ``raster/prepare_raster`` against the ``raster_uv_kernel`` time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def spans(cat, pred, lo=-math.inf, hi=math.inf):
        """Events of category ``cat`` whose name passes ``pred``, inside [lo, hi]."""
        return [e for e in events if e.get("cat") == cat and pred(e["name"])
                and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]

    def mean(xs):
        return sum(xs) / len(xs)

    def blocking(n):
        return "Synchronize" in n or n in ("cudaMemcpy", "cudaMemcpy2D", "cudaMemset")

    steps = sorted(spans("user_annotation", lambda n: n.startswith("train#")), key=lambda e: e["ts"])
    check(len(steps) >= 3, f"the trace holds {len(steps)} train steps")
    lo, hi = steps[1]["ts"], max(e["ts"] + e["dur"] for e in steps[1:])
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _union_ms(device, lo, hi)
    wall = (hi - lo) / 1e3
    split = []
    for r, nxt in zip(steps[1:], steps[2:] + [None]):
        a, b = r["ts"], r["ts"] + r["dur"]
        wait = sum(e["dur"] for e in spans("cuda_runtime", blocking, a, b)) / 1e3
        step_wall = ((nxt["ts"] if nxt else b) - a) / 1e3
        split.append((step_wall, r["dur"] / 1e3 - wait, wait))
    prep = [e["dur"] / 1e3 for e in spans("user_annotation",
                                          lambda n: n == "raster/prepare_raster", lo, hi)]
    uv = [e["dur"] / 1e3 for e in spans("kernel", lambda n: "raster_uv_kernel" in n, lo, hi)]
    check(prep and uv, f"the trace window lacks prepare_raster ({len(prep)}) or "
          f"raster_uv_kernel ({len(uv)}) events")
    n = len(split)
    return {"steps": n, "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "step_wall_ms": mean([x[0] for x in split]), "step_host_ms": mean([x[1] for x in split]),
            "step_wait_ms": mean([x[2] for x in split]), "step_device_ms": busy / n, "n_step": n,
            "prep_ms": mean(prep), "n_prep": len(prep), "uv_ms": mean(uv), "n_uv": len(uv)}


def trace_line(fig: dict) -> str:
    return (f"train steps 1-{fig['steps']} of epoch 0, {fig['wall_ms']:.3f} ms: device busy "
            f"{fig['busy_ms']:.3f} ms, idle share {fig['idle_share']:.4f}; a step (mean of "
            f"{fig['n_step']}): wall {fig['step_wall_ms']:.3f} ms, host {fig['step_host_ms']:.3f} "
            f"ms working and {fig['step_wait_ms']:.3f} ms waiting on the card, device busy "
            f"{fig['step_device_ms']:.3f} ms; prepare_raster host {fig['prep_ms']:.3f} ms a call "
            f"({fig['n_prep']} calls) against raster_uv_kernel {fig['uv_ms']:.4f} ms a launch "
            f"({fig['n_uv']} launches)")


def event_tags(run_dir: str) -> set:
    """The scalar tags of every TensorBoard event file under ``run_dir``."""
    from tensorboard.backend.event_processing.event_file_loader import LegacyEventFileLoader

    tags = set()
    for name in os.listdir(run_dir):
        if name.startswith("events.out.tfevents."):
            for ev in LegacyEventFileLoader(os.path.join(run_dir, name)).Load():
                tags.update(v.tag for v in ev.summary.value)
    return tags


def released_entry_point(card: str, read_counts, zero_counts) -> dict:
    """Phase 8: ``artiboost_torch.train.main`` on the released config at
    full width, DATASET.TRAIN left as HO3D (absent: synth-only) and
    DATASET.TEST a SyntheticHO split of 200 images; 2 epochs, a TEST pass
    after each, a trace of epoch 0; then ``--resume <dir> --evaluate``.
    Everything it writes is removed. -> the launches of the training run."""
    import torch
    import yaml

    from artiboost_torch import train
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["DATASET"]["TEST"] = {"TYPE": "SyntheticHO", "DATA_SPLIT": "test", "AUG": False,
                              "RAW_SIZE": 512, "N_SAMPLES": 200}
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=1024, VAL_LEN=2 * 128)
    cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    dump = None
    try:
        cfg_path = os.path.join(tmp, "released.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        zero_counts()
        t0 = time.perf_counter()
        out = train.main(["--cfg", cfg_path, "--exp_id", "smoke", "--epochs", "2",
                          "--test_freq", "1", "--profile_dir", os.path.join(tmp, "trace"),
                          "--profile_steps", "6"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        dump = out["dump_path"]
        hist, loader = out["history"], out["loader"]
        check(out["train_data"] is None and loader._mixed_counts() == (0, 128)
              and len(loader) == 8, "the released config did not train synth-only, 8 steps of 128")
        steps = sum(r["train"]["steps"] for r in hist)
        val_batches = sum(r.get("val", {}).get("batches", 0) for r in hist)
        tests = [r["test"] for r in hist if "test" in r]
        check(steps == 16 and val_batches == 4 and len(tests) == 2
              and all(t["batches"] == 2 and t["images"] == 200 for t in tests),
              f"ran {steps} train steps, {val_batches} val batches, test passes "
              f"{[(t['batches'], t['images']) for t in tests]}")
        check(launches == {"raster_uv": steps + val_batches, "raster_rgb": math.ceil(200 / 16),
                           "raster_rgb_binned": 0},
              f"phase 8 launches {launches}, expected {steps + val_batches} uv, 13 rgb, 0 binned")
        losses = [v for r in hist for v in r["train"]["final_loss"]]
        check(all(math.isfinite(v) for v in losses), f"non-finite train loss: {losses}")
        images = hist[1]["train"]["images"]
        rate = images / hist[1]["train"]["seconds"]
        traced_rate = hist[0]["train"]["images"] / hist[0]["train"]["seconds"]
        timer = out["timer"]
        del out, loader

        zero_counts()
        ev = train.main(["--resume", dump, "--evaluate"])
        check([set(r) for r in ev["history"]] == [{"epoch", "test"}]
              and ev["history"][0]["epoch"] == 2 and ev["history"][0]["test"]["batches"] == 2,
              f"--evaluate ran {ev['history']}")
        check(read_counts() == {"raster_uv": 0, "raster_rgb": 13, "raster_rgb_binned": 0},
              f"--evaluate launched {read_counts()}, expected the TEST init's 13 rgb alone")
        del ev

        evals = os.path.join(dump, "evaluations")
        from PIL import Image

        for split, epochs in (("train", (0, 1)), ("val", (0, 1)), ("test", (0, 1, 2))):
            for e in epochs:
                with open(os.path.join(evals, f"{split}_epoch_{e}.json")) as f:
                    m = json.load(f)
                for name in ("Hand3DPCKMetric", "Obj3DPCKMetric"):
                    auc, epe = m[name]["auc_all"], m[name]["epe_mean_all"]
                    check(math.isfinite(auc) and 0 <= auc <= 1 and math.isfinite(epe),
                          f"{split} epoch {e} {name}: auc {auc}, epe {epe}")
                check(all(math.isfinite(v) for v in m["Mean3DEPE"].values()),
                      f"{split} epoch {e} Mean3DEPE {m['Mean3DEPE']}")
                png = os.path.join(evals, f"{split}_epoch_{e}_Vis2DMetric.png")
                with Image.open(png) as im:
                    check(im.size == (6 * 224, 6 * 224), f"{png} is {im.size}")
        tags = event_tags(os.path.join(dump, "runs"))
        want = {"train/loss/final_loss"} | {f"{s}/{m}" for s in ("train", "val", "test") for m in (
            "LossesMetric/final_loss", "Hand3DPCKMetric/auc_all", "Obj3DPCKMetric/auc_all",
            "Mean3DEPE/joints_3d_abs_mepe")} | {"val/ValMetricMean3DEPE2/val_epe_mean"}
        check(want <= tags, f"the event file lacks {sorted(want - tags)}")
        traces = [os.path.join(tmp, "trace", n) for n in os.listdir(os.path.join(tmp, "trace"))]
        check(len(traces) == 1, f"expected one trace, found {traces}")
        fig = trace_figures(traces[0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dump:
            shutil.rmtree(dump, ignore_errors=True)
    print(f"released entry point ({card}): synth-only (HO3D absent), 2 epochs in {wall:.2f} s: "
          f"{steps} steps of 128, {val_batches} val batches, 2 TEST passes of 200 SyntheticHO "
          f"images (2 batches, the second padded from 72) and one --evaluate pass; launches "
          f"{launches}; train {rate:.2f} img/s in epoch 1 ({traced_rate:.2f} in the traced "
          f"epoch 0); final_loss {losses[0]:.6f} -> {losses[-1]:.6f}; evaluations, Vis2D "
          f"images, {len(tags)} TensorBoard tags and the trace checked", flush=True)
    for stage in ("dataset init", "pose sweep", "synth batch", "train step", "forward",
                  "metric+mining", "test pass"):
        n = max(timer.calls[stage], 1)
        print(f"  host stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
              f"{timer.seconds[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")
    print(f"trace ({card}), {trace_line(fig)}", flush=True)
    return launches


def other_recipe(phase: int, recipe: str, card: str, read_counts, zero_counts) -> dict:
    """Phases 9 and 10: ``artiboost_torch.train.main`` on a released recipe
    at full width, DATASET.TRAIN left as the recipe's (absent: synth-only),
    CONFIG_LEN_TRAIN 512 (4 steps of 128), VAL_LEN 128, EVAL_FREQ 1,
    VAL_START_EPOCH 0, 2 epochs, DATASET.TEST a SyntheticHO split of 128
    images and ``--test_freq 2``. Phase 9 (the Reg recipe) checks the MANO
    terms and that ManoBranch and the object head moved; phase 10 (the
    symmetric DexYCB recipe) the symmetric corner loss, the MSSD map, the
    mining from the averaged EPE and MSSD maps and the TEST pass's AR.
    Everything it writes is removed. -> the launches of the run."""
    import logging

    import torch
    import yaml

    from artiboost_torch import train
    from artiboost_torch.metrics.val_metric import ValMetricAR2, ValMetricMean3DEPE2
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", f"{recipe}.yaml"))
    cfg["DATASET"]["TEST"] = {"TYPE": "SyntheticHO", "DATA_SPLIT": "test", "AUG": False,
                              "RAW_SIZE": 512, "N_SAMPLES": 128}
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=512, VAL_LEN=128)
    cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
    with torch.random.fork_rng(devices=[]):  # the initialisation run() makes
        torch.manual_seed(int(cfg["TRAIN"]["MANUAL_SEED"]))
        init = build_arch(cfg["ARCH"], cfg["DATA_PRESET"]).model_list[0].state_dict()
    init = {k: v.clone() for k, v in init.items()}
    mining, warnings = [], []

    class Loader(train.ArtiBoostLoader):
        def step_eval(self, epoch_idx, evaluator):
            maps = {type(m).__name__: m.get_averaged_maps() for m in evaluator.metrics_list
                    if isinstance(m, (ValMetricMean3DEPE2, ValMetricAR2))}
            before = self.ccv.sample_weight_map.clone()
            super().step_eval(epoch_idx, evaluator)
            mining.append((maps, before, self.ccv.sample_weight_map.clone()))

    class Warnings(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = Warnings(logging.WARNING)
    logging.getLogger("artiboost_torch").addHandler(handler)
    orig_loader, train.ArtiBoostLoader = train.ArtiBoostLoader, Loader
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{recipe}_")
    dump = None
    try:
        cfg_path = os.path.join(tmp, f"{recipe}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        zero_counts()
        t0 = time.perf_counter()
        out = train.main(["--cfg", cfg_path, "--exp_id", f"smoke{phase}", "--epochs", "2",
                          "--test_freq", "2"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        dump = out["dump_path"]
        hist, loader = out["history"], out["loader"]
        check(out["train_data"] is None and loader._mixed_counts() == (0, 128)
              and len(loader) == 4, f"phase {phase}: {recipe} did not train synth-only, "
              "4 steps of 128")
        steps = sum(r["train"]["steps"] for r in hist)
        val_batches = sum(r.get("val", {}).get("batches", 0) for r in hist)
        tests = [r["test"] for r in hist if "test" in r]
        check(steps == 8 and val_batches == 2 and len(tests) == 1 and "test" in hist[1]
              and tests[0]["batches"] == 1 and tests[0]["images"] == 128,
              f"phase {phase}: ran {steps} train steps, {val_batches} val batches, test passes "
              f"{[(t['batches'], t['images']) for t in tests]}")
        check(launches == {"raster_uv": 10, "raster_rgb": 8, "raster_rgb_binned": 0},
              f"phase {phase} launches {launches}, expected 10 uv, 8 rgb, 0 binned")
        losses = [v for r in hist for v in r["train"]["final_loss"]]
        check(all(math.isfinite(v) for v in losses), f"phase {phase}: non-finite loss {losses}")
        terms = (("mano_shape", "mano_pca_pose") if phase == 9 else ("sym_corners_3d_loss",))
        for r in hist:
            for part in ("train", "val"):
                lm = r[part]["measures"]["LossesMetric"]
                check(all(math.isfinite(lm.get(t, math.nan)) for t in terms + ("final_loss",)),
                      f"phase {phase} epoch {r['epoch']} {part}: losses {lm}")
        check(len(mining) == 2, f"phase {phase}: step_eval ran {len(mining)} times")
        w = loader.ccv.sample_weight_map
        check(not bool(torch.all(w == 1.0)) and float(w.min()) >= 0.1 and float(w.max()) <= 10.0,
              f"phase {phase}: weight map [{float(w.min())}, {float(w.max())}]")
        model = out["model"].model_list[0]
        final = model.state_dict()
        heads = ("mano_branch.", "obj_transfhead.") if phase == 9 else ("box_head.",)
        names = [n for n, p in model.named_parameters() if n.startswith(heads)]
        still = [n for n in names if torch.equal(final[n].cpu(), init[n])]
        check(names and not still, f"phase {phase}: unchanged after training: {still}")
        evals = os.path.join(dump, "evaluations")
        with open(os.path.join(evals, "test_epoch_1.json")) as f:
            test_m = json.load(f)
        if phase == 9:
            for split, e in (("train", 0), ("train", 1), ("val", 0), ("val", 1), ("test", 1)):
                with open(os.path.join(evals, f"{split}_epoch_{e}.json")) as f:
                    m = json.load(f)
                for name in ("Hand3DPCKMetric", "Obj3DPCKMetric"):
                    auc = m[name]["auc_all"]
                    check(math.isfinite(auc) and 0 <= auc <= 1,
                          f"phase 9 {split} epoch {e} {name} auc {auc}")
            detail = (f"PCK auc_all in test: hand {test_m['Hand3DPCKMetric']['auc_all']:.4f}, "
                      f"object {test_m['Obj3DPCKMetric']['auc_all']:.4f}")
        else:
            for r in hist:
                v = r["val"]["measures"]["ValMetricAR2"]["val_mssd_mean"]
                check(math.isfinite(v), f"phase 10 epoch {r['epoch']}: val_mssd_mean {v}")
            for maps, before, after in mining:
                (epe, seen_e), (mssd, seen_m) = maps["ValMetricMean3DEPE2"], maps["ValMetricAR2"]
                both = seen_e & seen_m
                moved = after != before
                check(int(both.sum()) > 0 and bool(moved[both].any())
                      and not bool(moved[~both].any()),
                      f"phase 10: the reweight moved {int(moved.sum())} weights, "
                      f"{int(moved[~both].sum())} outside the {int(both.sum())} triplets both "
                      "maps saw")
            ar = test_m["AR"]
            check(all(0 <= ar[k] <= 1 for k in ("AR_MSSD", "AR_MSPD", "AR_BOP2"))
                  and math.isfinite(ar["MSSD"]), f"phase 10 TEST AR {ar}")
            absent = [m for m in warnings if m.startswith("MODEL_INFO_PATH")]
            check(bool(absent), "phase 10: no line says MODEL_INFO_PATH is absent")
            print(f"phase 10: {absent[0]}", flush=True)
            detail = (f"TEST AR_MSSD {ar['AR_MSSD']:.4f}, AR_MSPD {ar['AR_MSPD']:.4f}, MSSD "
                      f"{ar['MSSD']:.2f} mm; val_mssd_mean "
                      f"{hist[1]['val']['measures']['ValMetricAR2']['val_mssd_mean']:.2f} mm; "
                      f"mining from {int(both.sum())} triplets both maps saw")
        rate = hist[1]["train"]["images"] / hist[1]["train"]["seconds"]
        timer = out["timer"]
        del out, loader, model, final
    finally:
        train.ArtiBoostLoader = orig_loader
        logging.getLogger("artiboost_torch").removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)
        if dump:
            shutil.rmtree(dump, ignore_errors=True)
    print(f"phase {phase}, {recipe} ({card}): synth-only, 2 epochs in {wall:.2f} s: {steps} "
          f"steps of 128, {val_batches} val batches, one TEST pass of 128 SyntheticHO images; "
          f"launches {launches}; train {rate:.2f} img/s in epoch 1; final_loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; weights [{float(w.min()):.4f}, "
          f"{float(w.max()):.4f}]; {detail}", flush=True)
    for stage in ("dataset init", "pose sweep", "synth batch", "train step", "forward",
                  "metric+mining", "test pass"):
        n = max(timer.calls[stage], 1)
        print(f"  host stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
              f"{timer.seconds[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")
    return launches


REAL_OBJS = ("010_potted_meat_can", "021_bleach_cleanser", "006_mustard_bottle",
             "019_pitcher_base")
REAL_TRAIN_SEQS = {f"{p}{i}": 60 for p in ("ABF1", "GPMF1") for i in range(4)}  # 480 frames
REAL_TEST_SEQS = {"SM1": 80, "MPM10": 80}  # 160 frames: a batch of 128 and one padded from 32
REAL_HTML_IDS = tuple(i for i in range(17) if i != 2)  # 16 hands (the loader skips html_002)


def write_real_layout(root: str, repo_cfg) -> dict:
    """The released recipe's files under ``root`` in the official layouts
    (``artiboost_torch/datasets/layouts.py``): HO3D's train (480 frames) and
    evaluation (160) splits at 640x480 with their frame lists, the four
    YCB meshes of the recipe (48 x 64 = 3,072 vertices each, MTL, a
    1024x1024 texture), their supplementary meshes, 50 grasps each, 64
    backgrounds, 16 HTML hands and a torchvision-named ResNet34. -> what
    was written."""
    import numpy as np

    from artiboost_torch.datasets import layouts
    from artiboost_torch.mano.model import get_mano_model

    rng = np.random.RandomState(11)
    data = os.path.join(root, "data")
    n_train = layouts.write_ho3d(data, "train", REAL_TRAIN_SEQS, REAL_OBJS, rng, n_images=24)
    n_test = layouts.write_ho3d(data, "test", REAL_TEST_SEQS, REAL_OBJS, rng, n_images=8)
    layouts.write_ycb_models(os.path.join(data, "YCB_models_process"), REAL_OBJS, rng,
                             n_lat=48, n_lon=64, tex_size=1024)
    layouts.write_ycb_models(os.path.join(data, "YCB_models_supp"), REAL_OBJS, rng, n_lat=24,
                             n_lon=32, tex_size=64, mesh_name="textured_simple_ds.obj")
    layouts.write_grasps(os.path.join(root, "assets", "grasp_engine", "ycb_grasp"), REAL_OBJS,
                         50, rng)
    layouts.write_backgrounds(os.path.join(root, repo_cfg["MANAGER"]["RENDERER"]["BGS_PATH"]),
                              64, rng)
    mano = get_mano_model(device="cpu")
    layouts.write_html_hands(os.path.join(data, "HTML_supp"), REAL_HTML_IDS,
                             mano.v_template.numpy(), mano.faces.numpy(), rng)
    imagenet = os.path.join(root, "checkpoints", "imagenet", "resnet34-b627a593.pth")
    sd = layouts.write_imagenet_resnet(imagenet, "ResNet34", seed=5)
    return {"data": data, "n_train": n_train, "n_test": n_test, "imagenet": sd}


def real_data_recipe(card: str, kernels: dict, hold, read_counts, zero_counts, tmp: str):
    """Phase 11: ``artiboost_torch.train.main`` on the released recipe with
    its data on disk (``write_real_layout`` in the working directory
    ``tmp``), the config unchanged but DATA_ROOT, EVAL_FREQ 1 and
    VAL_START_EPOCH 0: 2 epochs of 6 mixed steps (80 HO3D + 48 synth), the
    val sweep of the released VAL_LEN, a TEST pass over the 160 evaluation
    frames after each epoch, a trace of epoch 0 through step 6. Holds B1 on
    a train batch at these assets against its twin and times it. The caller
    removes ``tmp``. -> (the launches of the run, {"root", "data", "ckpt"
    (the run's last checkpoint), "n_test"} for phase 13)."""
    import logging

    import torch
    import yaml

    from artiboost_torch import train
    from artiboost_torch.artiboost import renderer
    from artiboost_torch.datasets.hodata import HODataset
    from artiboost_torch.ops.rasterizer_cuda import prepare_raster, raster_uv
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
    records = {"parts": [], "test_idx": [], "backbone": None, "raster": None, "warnings": []}
    orig = {"union": train.union_concat, "pretrained": train.load_arch_pretrained,
            "device_half": HODataset.device_half, "raster": renderer.rasterize_batch_uv}

    def union(parts):
        records["parts"].append([int(p["image"].shape[0]) for p in parts])
        return orig["union"](parts)

    def pretrained(arch, arch_cfg):
        loaded = orig["pretrained"](arch, arch_cfg)
        records["backbone"] = {k: v.detach().cpu().clone() for k, v in
                               arch.model_list[0].state_dict().items() if k.startswith("backbone.")}
        return loaded

    def device_half(self, host, **kw):
        if self.data_split == "test":
            records["test_idx"].append(list(host.sample_idx))
        return orig["device_half"](self, host, **kw)

    def raster(*args, **kw):
        if records["raster"] is None:
            records["raster"] = (args, kw)
        return orig["raster"](*args, **kw)

    class Warnings(logging.Handler):
        def emit(self, record):
            records["warnings"].append(record.getMessage())

    handler = Warnings(logging.WARNING)
    logging.getLogger("artiboost_torch").addHandler(handler)
    train.union_concat, train.load_arch_pretrained = union, pretrained
    HODataset.device_half, renderer.rasterize_batch_uv = device_half, raster
    try:
        os.chdir(tmp)
        t0 = time.perf_counter()
        written = write_real_layout(tmp, cfg)
        t_write = time.perf_counter() - t0
        for split in ("TRAIN", "TEST"):
            cfg["DATASET"][split]["DATA_ROOT"] = written["data"]
        with open("released.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        zero_counts()
        t0 = time.perf_counter()
        out = train.main(["--cfg", "released.yaml", "--exp_id", "smoke11", "--epochs", "2",
                          "--test_freq", "1", "--profile_dir", os.path.join(tmp, "trace"),
                          "--profile_steps", "6"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        hist, loader, timer = out["history"], out["loader"], out["timer"]
        n_train, n_test = written["n_train"], written["n_test"]
        check(len(out["train_data"]) == n_train and len(out["test_data"]) == n_test,
              f"phase 11 built {len(out['train_data'] or [])} train and "
              f"{len(out['test_data'] or [])} test samples, wrote {n_train} and {n_test}")
        steps = sum(r["train"]["steps"] for r in hist)
        val_batches = sum(r.get("val", {}).get("batches", 0) for r in hist)
        check(loader._mixed_counts() == (80, 48) and len(loader) == 6 and steps == 12
              and records["parts"] == [[80, 48]] * steps,
              f"phase 11: batches {records['parts'][:3]}..., mixed counts "
              f"{loader._mixed_counts()}, {steps} steps")
        tests = [r["test"] for r in hist if "test" in r]
        want_idx = sorted(range(n_test))
        seen = [sorted(set(sum(records["test_idx"][2 * i:2 * i + 2], []))) for i in range(2)]
        check(len(tests) == 2 and all(t["batches"] == 2 for t in tests)
              and seen == [want_idx, want_idx],
              f"phase 11: TEST passes {[(t['batches'], t['images']) for t in tests]} did not "
              "cover every evaluation frame")
        stand_in = [m for m in records["warnings"] if "using synthetic" in m
                    or "not found" in m or "no local ImageNet" in m or "not ported" in m]
        check(not stand_in, f"phase 11: stand-in warnings {stand_in}")
        lib = loader.obj_lib
        check(lib.names == REAL_OBJS and lib.n_verts.tolist() == [2048] * 4
              and lib.textures is not None, f"phase 11: object library {lib.names} with "
              f"{lib.n_verts.tolist()} vertices (files hold 3072 each, decimated to 2048)")
        check(loader.assets.backgrounds.shape[0] == 64
              and loader.assets.hand_textures.shape[0] == len(REAL_HTML_IDS)
              and loader.grasp_lib.hand_pose.shape[:2] == (4, 50),
              f"phase 11: {loader.assets.backgrounds.shape[0]} backgrounds, "
              f"{loader.assets.hand_textures.shape[0]} hand textures, grasps "
              f"{tuple(loader.grasp_lib.hand_pose.shape)}")
        file_sd = written["imagenet"]
        bad = [k for k, v in records["backbone"].items() if not k.endswith("num_batches_tracked")
               and not torch.equal(v, file_sd[k[len("backbone."):]])]
        check(records["backbone"] and not bad, f"phase 11: backbone differs from the file: {bad[:3]}")
        check(launches == {"raster_uv": steps + val_batches, "raster_rgb": 0,
                           "raster_rgb_binned": 0},
              f"phase 11 launches {launches}, expected {steps + val_batches} uv, 0 rgb, 0 binned")
        losses = [v for r in hist for v in r["train"]["final_loss"]]
        check(all(math.isfinite(v) for v in losses), f"phase 11: non-finite train loss {losses}")
        w = loader.ccv.sample_weight_map
        check(not bool(torch.all(w == 1.0)) and float(w.min()) >= 0.1 and float(w.max()) <= 10.0,
              f"phase 11: weight map [{float(w.min())}, {float(w.max())}] after the reweight")
        rate = hist[1]["train"]["images"] / hist[1]["train"]["seconds"]
        geom, decode = (sum(r["train"]["real_host"][i] for r in hist) / steps for i in (0, 1))
        traces = [os.path.join(tmp, "trace", n) for n in os.listdir(os.path.join(tmp, "trace"))]
        check(len(traces) == 1, f"phase 11: expected one trace, found {traces}")
        fig = trace_figures(traces[0])
        atlas = tuple(loader.synth_batch_fn.atlas.shape)
        args, kw = records["raster"]
        real = {"root": tmp, "data": written["data"], "n_test": n_test,
                "ckpt": os.path.join(tmp, out["dump_path"], "checkpoints", "latest.pt")}
        check(os.path.isfile(real["ckpt"]), f"phase 11 left no checkpoint at {real['ckpt']}")
        del out, loader
    finally:
        os.chdir(REPO)
        train.union_concat, train.load_arch_pretrained = orig["union"], orig["pretrained"]
        HODataset.device_half, renderer.rasterize_batch_uv = orig["device_half"], orig["raster"]
        logging.getLogger("artiboost_torch").removeHandler(handler)
    import cv2
    print(f"phase 11, released recipe on real-layout data ({card}): {n_train} HO3D train and "
          f"{n_test} evaluation frames at 640x480 (PNG, decoded by OpenCV "
          f"{cv2.__version__}), written in {t_write:.2f} s; 2 epochs in {wall:.2f} s: {steps} steps of "
          f"80 real + 48 synth, {val_batches} val batches, 2 TEST passes of 2 batches; launches "
          f"{launches}; train {rate:.2f} img/s in epoch 1; final_loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; weights [{float(w.min()):.4f}, {float(w.max()):.4f}]; assets loaded "
          f"from disk: 4 YCB meshes (3072 -> 2048 vertices, textures 1024 -> {lib.textures.shape[1]}), "
          f"200 grasps, 64 backgrounds, {len(REAL_HTML_IDS)} HTML hands, ImageNet ResNet34 "
          "(equal to the file before the first step)", flush=True)
    n_real = max(timer.calls["real batch"], 1)
    print(f"  real batch of 80, per step over both epochs: host geometry {geom * 1e3:.3f} ms and "
          f"decode {decode * 1e3:.3f} ms (producer thread and decode pool), upload+warp "
          f"{timer.seconds['real batch'] * 1e3 / n_real:.3f} ms, the step's wait on the "
          f"prefetcher {timer.seconds['real wait'] * 1e3 / max(timer.calls['real wait'], 1):.3f} ms",
          flush=True)
    for stage in ("dataset init", "pose sweep", "real wait", "real batch", "synth batch",
                  "train step", "forward", "metric+mining", "test pass"):
        n = max(timer.calls[stage], 1)
        print(f"  host stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
              f"{timer.seconds[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")
    print(f"  trace ({card}), {trace_line(fig)}", flush=True)
    inp = prepare_raster(*args, **kw)
    hold(raster_uv, inp, "phase 11 train batch at the YCB assets")
    print(f"  raster_uv at the real assets: F={inp.order.shape[-1]} (LOD of the 2048-vertex "
          f"meshes and the hand), texture atlas {atlas}; stand-in figure of phase 3: "
          f"{kernels['raster_uv']['ms']:.4f} ms", flush=True)
    timing(raster_uv, inp, 3, card, torch)
    del inp
    return launches, real


def synth_options(card: str, hold, read_counts, zero_counts) -> dict:
    """Phase 12: ``artiboost_torch.train.main`` on the released Clas recipe at
    full width, synth-only (CONFIG_LEN_TRAIN 512: 4 steps of 128, VAL_LEN
    128, 1 epoch, no TEST pass), twice: run a with RENDERER.TEXTURED false
    (the Gouraud route, kernel B2 for every synthetic image), MOTION_BLUR 7
    at MOTION_BLUR_PROB 0.5 and the ``random_2`` scrambler; run b with
    BILINEAR (kernel B1 and the bilinear gather) and ``random_3``. Holds B2
    on run a's first synth batch against its twin and checks that the blur
    changed the foreground of exactly the images its draw picked. Everything
    it writes is removed. -> the launches of both runs, summed."""
    import torch
    import yaml

    from artiboost_torch import train
    from artiboost_torch.artiboost import renderer, synth_batch
    from artiboost_torch.ops.rasterizer_cuda import prepare_raster, raster_rgb
    from artiboost_torch.utils.config import load_config

    runs = {"a": ({"TEXTURED": False, "MOTION_BLUR": 7, "MOTION_BLUR_PROB": 0.5}, "random_2"),
            "b": ({"BILINEAR": True}, "random_3")}
    total = {}
    for name, (options, scrambler) in runs.items():
        cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
        cfg["MANAGER"].update(CONFIG_LEN_TRAIN=512, VAL_LEN=128)
        cfg["MANAGER"]["RENDERER"].update(options)
        cfg["MANAGER"]["SCRAMBLER"]["TYPE"] = scrambler
        cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
        rec = {"raster": None, "blur": None}
        orig = {"raster": renderer.rasterize_batch_rgb, "blur": renderer.motion_blur_h,
                "scene": synth_batch.render_scene}

        def raster(*args, **kw):
            if rec["raster"] is None:
                rec["raster"] = (args, kw)
            return orig["raster"](*args, **kw)

        def blur(img, k):
            out = orig["blur"](img, k)
            if rec["blur"] is None:
                rec["blur"] = {"raw": img.clone()}
            return out

        def scene(*args, **kw):
            rgb, depth = orig["scene"](*args, **kw)
            if rec["blur"] is not None and "out" not in rec["blur"]:
                rec["blur"].update(mb=args[6]["mb"].clone(), out=rgb.clone(), depth=depth.clone())
            return rgb, depth

        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_options_{name}_")
        dump = None
        renderer.rasterize_batch_rgb, renderer.motion_blur_h = raster, blur
        synth_batch.render_scene = scene
        try:
            cfg_path = os.path.join(tmp, "options.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            zero_counts()
            t0 = time.perf_counter()
            out = train.main(["--cfg", cfg_path, "--exp_id", f"smoke12{name}", "--epochs", "1",
                              "--test_freq", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            dump = out["dump_path"]
            hist, loader, timer = out["history"], out["loader"], out["timer"]
            sc = loader.synth_cfg
            check(out["train_data"] is None and loader._mixed_counts() == (0, 128)
                  and len(loader) == 4, f"phase 12{name} did not train synth-only, 4 steps of 128")
            check((sc.textured, sc.bilinear, sc.motion_blur, loader.synth_batch_fn.textured)
                  == (name == "b", name == "b", 7 if name == "a" else 0, name == "b"),
                  f"phase 12{name}: options not in force: {sc}")
            steps = hist[0]["train"]["steps"]
            val_batches = hist[0].get("val", {}).get("batches", 0)
            check(steps == 4 and val_batches == 1,
                  f"phase 12{name}: {steps} train steps, {val_batches} val batches")
            want = {"raster_uv": 0 if name == "a" else steps + val_batches,
                    "raster_rgb": steps + val_batches if name == "a" else 0,
                    "raster_rgb_binned": 0}
            check(launches == want, f"phase 12{name} launches {launches}, expected {want}")
            losses = hist[0]["train"]["final_loss"]
            check(all(math.isfinite(v) for v in losses), f"phase 12{name}: non-finite loss {losses}")
            lm = hist[0]["val"]["measures"]["LossesMetric"]
            check(math.isfinite(lm["final_loss"]), f"phase 12{name}: val losses {lm}")
            rate = hist[0]["train"]["images"] / hist[0]["train"]["seconds"]
            del out, loader
        finally:
            renderer.rasterize_batch_rgb, renderer.motion_blur_h = orig["raster"], orig["blur"]
            synth_batch.render_scene = orig["scene"]
            shutil.rmtree(tmp, ignore_errors=True)
            if dump:
                shutil.rmtree(dump, ignore_errors=True)
        detail = ""
        if name == "a":
            args, kw = rec["raster"]
            inp = prepare_raster(*args, **kw)
            hold(raster_rgb, inp, f"phase 12a synth batch (untextured, B={inp.geom.shape[0]} at "
                                  f"{inp.height}x{inp.width})")
            timing(raster_rgb, inp, 3, card, torch)
            del inp
            b = rec["blur"]
            ry = b["out"].shape[1] // b["raw"].shape[1]
            up = b["raw"].repeat_interleave(ry, 1).repeat_interleave(ry, 2)
            fg = b["depth"] > 0
            changed = ((b["out"] != up).any(-1) & fg).flatten(1).any(1)
            picked = b["mb"] < 0.5
            has_fg = fg.flatten(1).any(1)
            check(not bool(changed[~picked].any()) and bool(changed[picked & has_fg].all())
                  and 0.3 <= float(picked.float().mean()) <= 0.7,
                  f"phase 12a: the blur changed {int(changed.sum())} foregrounds, its draw "
                  f"picked {int(picked.sum())} of {picked.numel()} images")
            detail = (f"; the blur changed the foreground of the {int(picked.sum())} of "
                      f"{picked.numel()} images its draw picked, and of no other")
        print(f"phase 12{name}, {options} scrambler {scrambler} ({card}): synth-only, 1 epoch in "
              f"{wall:.2f} s: {steps} steps of 128, {val_batches} val batch; launches {launches}; "
              f"train {rate:.2f} img/s in epoch 0 (its first steps included); final_loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}{detail}", flush=True)
        for stage in ("pose sweep", "synth batch", "train step", "forward"):
            n = max(timer.calls[stage], 1)
            print(f"  stage {stage}: {timer.seconds[stage] * 1e3 / n:.3f} ms per call over "
                  f"{timer.calls[stage]} calls")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total


def submission(card: str, real: dict, hold, read_counts, zero_counts) -> dict:
    """Phase 13: ``artiboost_torch.submit_reload.main`` on the released
    evaluation config (config_eval/eval_ho3dv2_clasbased_artiboost.yaml:
    ResNet34 at 224 x 224, batch 128) with DATA_ROOT at phase 11's files and
    ``--reload`` of phase 11's last checkpoint, ``--submit_dump
    --postprocess_fit_mesh --postprocess_draw``: HO3D v2's evaluation split
    of 160 frames, one full batch and a tail padded from 32. Checks the
    Codalab JSON and zip, the fitted meshes against IKNet's warm start, the
    overlays (kernel B2, one launch a tile; the first tile's raster held
    against B2's twin and timed), the recorded measures. -> the launches of
    the run."""
    import zipfile

    import torch
    import yaml

    from artiboost_torch import submit_reload
    from artiboost_torch.ops.rasterizer_cuda import prepare_raster, raster_rgb
    from artiboost_torch.postprocess.fitting import FittingUnit
    from artiboost_torch.submit.epoch_pass import HOSubmitEpochPass
    from artiboost_torch.utils.config import load_config

    tmp = real["root"]
    cfg = load_config(os.path.join(REPO, "config_eval", "eval_ho3dv2_clasbased_artiboost.yaml"))
    cfg["DATASET"]["TEST"]["DATA_ROOT"] = real["data"]
    from artiboost_torch.viztools import draw as viz

    rec = {"fit": [], "fit_s": 0.0, "draw_s": 0.0, "draws": 0, "raster": None}
    orig = {"fit": FittingUnit.__call__, "draw": HOSubmitEpochPass.draw_batch,
            "raster": viz.rasterize_batch_rgb}

    def raster(*args, **kw):
        if rec["raster"] is None:
            rec["raster"] = (args, kw)
        return orig["raster"](*args, **kw)

    def fit(self, joints_abs, batch=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["fit"](self, joints_abs, batch)
        torch.cuda.synchronize()
        rec["fit_s"] += time.perf_counter() - t0
        rec["fit"].append((self, joints_abs.clone(), out["joints"], out["hand_verts"]))
        return out

    def draw(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig["draw"](self, *args, **kw)
        torch.cuda.synchronize()
        rec["draw_s"] += time.perf_counter() - t0
        rec["draws"] += 1

    FittingUnit.__call__, HOSubmitEpochPass.draw_batch = fit, draw
    viz.rasterize_batch_rgb = raster
    try:
        os.chdir(tmp)
        with open("eval.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        draw_dir = os.path.join(tmp, "draw")
        zero_counts()
        out = submit_reload.main(["--cfg", "eval.yaml", "--reload", real["ckpt"], "--exp_id",
                                  "smoke13", "--submit_dump", "--postprocess_fit_mesh",
                                  "--postprocess_draw", "--postprocess_draw_path", draw_dir])
        torch.cuda.synchronize()
        launches = read_counts()
        check(out["weights"] == real["ckpt"] and out["batches"] == 2,
              f"phase 13 evaluated {out['weights']} over {out['batches']} batches")
        with open(out["pred_path"]) as f:
            xyz, verts = json.load(f)
        check(len(xyz) == len(verts) == real["n_test"] == 160
              and all(len(j) == 21 and all(len(p) == 3 for p in j) for j in xyz)
              and all(len(v) == 778 and all(len(p) == 3 for p in v) for v in verts),
              f"phase 13 dumped {len(xyz)} joint and {len(verts)} vert lists")
        zipped = out["pred_path"].replace(".json", ".zip")
        with zipfile.ZipFile(zipped) as zf:
            infos = zf.infolist()
            check([i.filename for i in infos] == [os.path.basename(out["pred_path"])]
                  and infos[0].compress_type == zipfile.ZIP_DEFLATED
                  and zf.read(infos[0].filename) == open(out["pred_path"], "rb").read(),
                  f"phase 13 zip holds {[(i.filename, i.compress_type) for i in infos]}")
        fitted_verts = torch.cat([r[3] for r in rec["fit"]])
        check(len(rec["fit"]) == 2 and bool(torch.isfinite(fitted_verts).all()),
              f"phase 13: {len(rec['fit'])} fits, finite {bool(torch.isfinite(fitted_verts).all())}")
        err_fit, err_warm = [], []
        for unit, joints, fitted, _ in rec["fit"]:
            err_fit.append((fitted - joints).norm(dim=-1).mean(-1))
            err_warm.append((unit.warm_start(joints)["joints"] - joints).norm(dim=-1).mean(-1))
        err_fit, err_warm = (float(torch.cat(e).mean()) for e in (err_fit, err_warm))
        check(err_fit < err_warm, f"phase 13: fitted joints {err_fit * 1e3:.3f} mm from the "
              f"prediction, IKNet's warm start {err_warm * 1e3:.3f} mm")
        pngs = sorted(os.listdir(draw_dir))
        check(pngs == ["eval_batch_0000.png", "eval_batch_0001.png"] and rec["draws"] == 2,
              f"phase 13 overlays {pngs}")
        tiles = 2 * 16
        check(launches == {"raster_uv": 0, "raster_rgb": tiles, "raster_rgb_binned": 0},
              f"phase 13 launches {launches}, expected {tiles} rgb (one a tile), no other")
        m = out["measures"]
        check(all(math.isfinite(v) for name in m for v in m[name].values()),
              f"phase 13 measures {m}")
        eval_ms = (out["seconds"] - rec["fit_s"] - rec["draw_s"]) * 1e3 / out["batches"]
    finally:
        os.chdir(REPO)
        FittingUnit.__call__, HOSubmitEpochPass.draw_batch = orig["fit"], orig["draw"]
        viz.rasterize_batch_rgb = orig["raster"]
    print(f"phase 13, submission of config_eval/eval_ho3dv2_clasbased_artiboost.yaml ({card}): "
          f"{len(xyz)} evaluation frames in {out['batches']} batches of 128 from phase 11's last "
          f"checkpoint, {out['seconds']:.2f} s; launches {launches}; Codalab JSON of {len(xyz)} "
          f"joint and vert lists and its zip; fitted joints {err_fit * 1e3:.3f} mm from the "
          f"prediction against IKNet's warm start {err_warm * 1e3:.3f} mm; "
          f"Mean3DEPE joints {m['Mean3DEPE']['joints_3d_abs_mepe']:.2f} mm", flush=True)
    print(f"  per batch of 128 ({card}): eval pass (decode, forward, metrics, dump rows) "
          f"{eval_ms:.3f} ms; FittingUnit (20 Adam steps through MANO) "
          f"{rec['fit_s'] * 1e3 / len(rec['fit']):.3f} ms; draw (16 overlay tiles) "
          f"{rec['draw_s'] * 1e3 / rec['draws']:.3f} ms", flush=True)
    args, kw = rec["raster"]
    inp = prepare_raster(*args, **kw)
    hold(raster_rgb, inp, f"phase 13 overlay tile (fitted hand and object box, "
                          f"{inp.height}x{inp.width})")
    timing(raster_rgb, inp, 3, card, torch)
    return launches


DP_RANK_TIMEOUT_S = 600  # each phase-14 process; its process group times out at 300 s


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_worker(spec: dict):
    """One process of phase 14 (``chip_smoke.py --dp-worker <json>``):
    ``artiboost_torch.train.main`` with ``--multihost`` as rank ``rank`` of
    ``world`` in ``workdir``, B1's launches and batch sizes counted around
    it, the state digested where the recorder saves it and where a resume
    restores it, then B1 held against its twin on the first rows it
    rasterized; the record goes to ``out`` as JSON, and with ``params`` the
    trainable parameters as the step started and ended, the first step's
    gradients (averaged over the ranks, before the clip) and, over more
    than one rank, those one process computes from the same batch, twice,
    go there (``torch.save``)."""
    import torch

    sys.path.insert(0, REPO)
    os.chdir(spec["workdir"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from artiboost_torch import train
    from artiboost_torch.artiboost import renderer
    from artiboost_torch.artiboost.loader import ArtiBoostLoader, DrawSource
    from artiboost_torch.models import layers
    from artiboost_torch.ops.rasterizer_cuda import (finish_uv_raster, prepare_raster, raster_rgb,
                                                     raster_rgb_binned, raster_uv)
    from artiboost_torch.parallel import mesh
    from artiboost_torch.parallel.train_state import TrainStep
    from artiboost_torch.utils.recorder import NullRecorder, Recorder

    rec = {"uv_sizes": [], "saved": {}, "restored": {}, "draws": []}
    uv_call, params = {}, {}
    orig = {"uv": renderer.rasterize_batch_uv, "close": mesh.close, "init": TrainStep.__init__,
            "forward_backward": TrainStep.forward_backward,
            "triplets": DrawSource.triplets, "synth": DrawSource.synth,
            "save": (Recorder.record_checkpoints, NullRecorder.record_checkpoints),
            "resume": (Recorder.resume_checkpoints, NullRecorder.resume_checkpoints),
            "load": ArtiBoostLoader.load_state_dict}

    def step_digests(step):
        opt = [v for s in step.optimizer.state.values() for v in s.values()
               if isinstance(v, torch.Tensor)]
        return {"params": _digest(step.model.parameters()),
                "buffers": _digest(step.model.buffers()), "optimizer": _digest(opt),
                "step": step.step}

    def loader_digests(state):
        return {k: _digest([torch.as_tensor(np.asarray(state[k]))])
                for k in ("sample_weight_map", "occurrence_map", "rng_state")}

    def uv(*args, **kw):
        rec["uv_sizes"].append(int(args[0].shape[0]))
        uv_call.setdefault("call", (args, kw))
        return orig["uv"](*args, **kw)

    def init_step(self, *args, **kw):
        orig["init"](self, *args, **kw)
        params.setdefault("init", [p.detach().cpu().clone() for p in self.params])

    class _OneRankBatchNorm:
        """``models.layers``'s view of the mesh for ``one_process_grads``:
        BatchNorm keeps its process-group formula with identity
        collectives, so both sides of the comparison run the same
        arithmetic on rows split or whole."""
        world = staticmethod(lambda: 2)
        all_reduce_sum_ = staticmethod(lambda t: t)

    def one_process_grads(step, batch, loss_draws):
        """The first step's gradients as one process computes them from the
        same parameters on the whole global batch (every rank's rows,
        gathered): the step with every collective off; BatchNorm's buffers
        and the ranks' gradients are put back after."""
        import torch.distributed as dist

        n = int(batch["image"].shape[0])
        rows = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor) and v.dim()
                and v.shape[0] == n}
        shapes = [None] * mesh.world()
        dist.all_gather_object(shapes, {k: (tuple(v.shape), str(v.dtype)) for k, v in rows.items()})
        check(all(s == shapes[0] for s in shapes), f"the ranks' batches differ in shape: {shapes}")
        full = dict(batch, **{k: mesh.all_gather_rows(v.to(torch.uint8)).bool()
                              if v.dtype == torch.bool else mesh.all_gather_rows(v)
                              for k, v in rows.items()})
        grads, buffers = [p.grad for p in step.params], [b.clone() for b in step.model.buffers()]
        active, mesh.active = mesh.active, lambda: False
        layers.mesh = _OneRankBatchNorm
        try:
            orig["forward_backward"](step, full, loss_draws)
        finally:
            mesh.active, layers.mesh = active, mesh
        one = [p.grad.detach().cpu().clone() for p in step.params]
        for p, g in zip(step.params, grads):
            p.grad = g
        with torch.no_grad():
            for b, saved in zip(step.model.buffers(), buffers):
                b.copy_(saved)
        return one

    def forward_backward(self, batch, loss_draws):
        out = orig["forward_backward"](self, batch, loss_draws)
        if "grad" not in params:
            params["grad"] = [p.grad.detach().cpu().clone() for p in self.params]
            if mesh.world() > 1:
                params["grad_one"] = one_process_grads(self, batch, loss_draws)
                params["grad_again"] = one_process_grads(self, batch, loss_draws)
        return out

    def leaves(tree):
        return ([t for k in sorted(tree) for t in leaves(tree[k])] if isinstance(tree, dict)
                else [tree])

    def triplets(self, space, n, replace):
        flat = orig["triplets"](self, space, n, replace)
        rec["draws"].append(["triplets", _digest([flat]), _digest([space.blacklist_map])])
        return flat

    def synth(self, synth_fn, B):
        draws = orig["synth"](self, synth_fn, B)
        rec["draws"].append(["synth", _digest(leaves(draws))])
        return draws

    def close():
        rec["backend"], rec["world"] = mesh.backend(), mesh.world()
        orig["close"]()

    def saving(fn):
        def wrapped(self, step, epoch, artiboost_state=None, snapshot=10):
            rec["saved"] = dict(step_digests(step), **loader_digests(artiboost_state))
            return fn(self, step, epoch, artiboost_state, snapshot)
        return wrapped

    def resuming(fn):
        def wrapped(self, step, path=None):
            epoch = fn(self, step, path)
            rec["restored"].update(step_digests(step), epoch=epoch)
            return epoch
        return wrapped

    def load_state_dict(self, state):
        orig["load"](self, state)
        rec["restored"].update(loader_digests(self.state_dict()))

    renderer.rasterize_batch_uv, mesh.close, TrainStep.__init__ = uv, close, init_step
    TrainStep.forward_backward = forward_backward
    DrawSource.triplets, DrawSource.synth = triplets, synth
    Recorder.record_checkpoints, NullRecorder.record_checkpoints = map(saving, orig["save"])
    Recorder.resume_checkpoints, NullRecorder.resume_checkpoints = map(resuming, orig["resume"])
    ArtiBoostLoader.load_state_dict = load_state_dict
    argv = (["--resume", spec["resume"]] if spec.get("resume") else ["--cfg", spec["cfg"]])
    argv += ["--epochs", "1", "--test_freq", "0", "--multihost", "--coordinator",
             f"localhost:{spec['port']}", "--num_processes", str(spec["world"]),
             "--process_id", str(spec["rank"])]
    kernels = (raster_uv, raster_rgb, raster_rgb_binned)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {k.name: k.launches for k in kernels}
    hist = out["history"]
    rec["final_loss"] = [float(v) for h in hist for v in h["train"]["final_loss"]]
    rec["steps"] = sum(h["train"]["steps"] for h in hist)
    rec["val_batches"] = sum(h.get("val", {}).get("batches", 0) for h in hist)
    rec["train_seconds"] = sum(h["train"]["seconds"] for h in hist)
    rec["images"] = sum(h["train"]["images"] for h in hist)
    rec["dump_path"] = (os.path.join(spec["workdir"], out["dump_path"])
                        if out["dump_path"] else None)
    rec["final"] = dict(step_digests(out["step"]), **loader_digests(out["loader"].state_dict()))
    rec["device"] = str(out["step"].params[0].device)
    if spec.get("params"):
        params["final"] = [p.detach().cpu().clone() for p in out["step"].params]
        torch.save(params, spec["params"])
    if not spec.get("resume"):
        inp = prepare_raster(*uv_call["call"][0], **uv_call["call"][1])
        err, equal = compare(raster_uv, finish_uv_raster, inp, torch)
        rec["uv_hold"] = {"B": int(inp.geom.shape[0]), "max_abs_err": err, "equal": equal}
    with open(spec["out"], "w") as f:
        json.dump(rec, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_launch(world: int, tmp: str, tag: str, worker=None, **spec) -> list:
    """``world`` phase-14 processes started together (``worker``: the
    command that starts one, before its JSON spec) -> their records, rank
    0's with ``params``, the path of its parameters; a process that fails or
    outlives DP_RANK_TIMEOUT_S fails the phase."""
    port = _free_port()
    worker = worker or [sys.executable, os.path.abspath(__file__), "--dp-worker"]
    procs, specs = [], []
    for r in range(world):
        specs.append(dict(spec, rank=r, world=world, port=port, workdir=tmp,
                          out=os.path.join(tmp, f"{tag}_rank{r}.json"),
                          params=None if r or spec.get("resume") else os.path.join(tmp,
                                                                                   f"{tag}.pt")))
        procs.append(subprocess.Popen(worker + [json.dumps(specs[-1])], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"phase 14 {tag}: a rank outlived {DP_RANK_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"phase 14 {tag} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    records = []
    for s in specs:
        with open(s["out"]) as f:
            records.append(dict(json.load(f), params=s["params"]))
    return records


def _dp_config(tmp: str, dtype: str = "bfloat16") -> str:
    """The released Clas recipe cut to 4 steps of a global 128 and one val
    batch, its convolutions and matmuls in ``dtype``, written to ``tmp``
    -> its path."""
    import yaml

    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=512, VAL_LEN=128)
    cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
    cfg["ARCH"]["DTYPE"] = dtype
    path = os.path.join(tmp, f"dp_{dtype}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def dp_readings(ranks: list, one: Optional[list] = None) -> dict:
    """An N-rank run, by itself and against a 1-process run: ``grad``, the
    first step's gradients apart from those one process computes on the
    same global batch in the same run, and ``again``, one process's
    computed twice, apart, each as a share of their norm (L2 over every
    trainable parameter, in float64); with ``one``, each step's loss apart,
    relative (``first``, ``last``, ``steps``), ``gap``, how far the
    parameters end apart as a share of how far that run moved them, and
    ``same_start``, whether both started from the same bits."""
    import torch

    def l2(xs, ys):
        return math.sqrt(sum(float(((x.double() - y.double()) ** 2).sum())
                             for x, y in zip(xs, ys)))

    a = torch.load(ranks[0]["params"])
    norm = l2(a["grad_one"], [0 * g for g in a["grad_one"]])
    got = {"grad": l2(a["grad"], a["grad_one"]) / norm,
           "again": l2(a["grad_again"], a["grad_one"]) / norm}
    if one:
        b = torch.load(one[0]["params"])
        rel = [abs(x - y) / abs(y) for x, y in zip(ranks[0]["final_loss"], one[0]["final_loss"])]
        got.update(first=rel[0], last=rel[-1], steps=rel,
                   gap=l2(a["final"], b["final"]) / l2(b["final"], b["init"]),
                   same_start=all(torch.equal(x, y) for x, y in zip(a["init"], b["init"])))
    return got


def _dp_check(ranks: list, one: Optional[list], backend: str, devices: list,
              label: str) -> dict:
    """The records of an N-rank run, and against the 1-process run's if
    ``one``: the backend and cards, 4 steps and a val batch of 128 global
    rows, one B1 launch a step and a val batch at 128 / N rows, B1
    bit-equal to its twin on each rank's first rows, every rank's state
    bit-equal; with ``one``, the 1-process run on NCCL, both runs from the
    same start and the losses within DP_LOSS_RTOL; without it (a float32
    run), the first step's gradients within DP_GRAD_RTOL of one process's
    on the same batch -> ``dp_readings`` with ``uv_err``."""
    n = len(ranks)
    for r, rec in enumerate(ranks):
        check(rec["backend"] == backend and rec["world"] == n and rec["device"] == devices[r],
              f"{label} rank {r}: backend {rec['backend']}, world {rec['world']}, "
              f"{rec['device']}")
        check(rec["steps"] == 4 and rec["val_batches"] == 1 and rec["images"] == 512,
              f"{label} rank {r}: {rec['steps']} steps, {rec['val_batches']} val batches, "
              f"{rec['images']} images")
        want = rec["steps"] + rec["val_batches"]
        check(rec["launches"] == {"raster_uv": want, "raster_rgb": 0, "raster_rgb_binned": 0}
              and rec["uv_sizes"] == [128 // n] * want,
              f"{label} rank {r}: launches {rec['launches']} at B {rec['uv_sizes']}, "
              f"expected {want} uv at B = {128 // n}")
        hold = rec["uv_hold"]
        print(f"raster_uv {label} rank {r}'s first train batch (B={hold['B']}): "
              f"bit-equal={hold['equal']} max_abs_err={hold['max_abs_err']}", flush=True)
        check(hold["equal"] and hold["B"] == 128 // n,
              f"raster_uv differs from its plain twin on {label} rank {r}'s rows")
        check(all(math.isfinite(v) for v in rec["final_loss"]),
              f"{label} rank {r}: losses {rec['final_loss']}")
        if rec["draws"] != ranks[0]["draws"]:
            print(f"{label}: rank {r}'s draws differ from rank 0's:", flush=True)
            for i, (a, b) in enumerate(zip(rec["draws"], ranks[0]["draws"])):
                print(f"  draw {i}: rank {r} {a}, rank 0 {b}{'' if a == b else '  <-'}",
                      flush=True)
        check(rec["final"] == ranks[0]["final"] and rec["saved"] == ranks[0]["saved"]
              and rec["final_loss"] == ranks[0]["final_loss"]
              and rec["draws"] == ranks[0]["draws"],
              f"{label}: rank {r} differs from rank 0 after the epoch: {rec['final']} "
              f"{ranks[0]['final']}")
    got = dp_readings(ranks, one)
    got["uv_err"] = max(rec["uv_hold"]["max_abs_err"] for rec in ranks)
    if not one:
        check(got["grad"] <= DP_GRAD_RTOL,
              f"{label}: the first step's gradients over {n} ranks {got['grad']:.4e} of their "
              f"norm from one process's on the same batch (bound {DP_GRAD_RTOL}; one "
              f"process's twice {got['again']:.4e})")
        return got
    check(one[0]["backend"] == "nccl" and one[0]["world"] == 1,
          f"{label}: the 1-process --multihost run joined {one[0]['backend']}")
    check(got["same_start"], f"{label}: {n} ranks and 1 process started from other parameters")
    check(all(got[k] <= b for k, b in DP_LOSS_RTOL.items()),
          f"{label}: over {n} ranks against 1 process, the losses "
          f"{ranks[0]['final_loss']} against {one[0]['final_loss']} ({got['first']:.3e} and "
          f"{got['last']:.3e} apart; bounds {DP_LOSS_RTOL})")
    return got


def _rate(rec: dict) -> float:
    return rec["images"] / rec["train_seconds"]


def _dp_line(got: dict, got32: dict) -> str:
    return (f"the steps' losses {', '.join(f'{v:.3e}' for v in got['steps'])} apart from 1 "
            f"process's (bounds {DP_LOSS_RTOL}), the parameters {got['gap']:.4e} of the "
            f"1-process run's movement; the first step's gradients from one process's on the "
            f"same batch {got['grad']:.4e} of their norm in bf16, {got32['grad']:.4e} in float32 "
            f"(bound {DP_GRAD_RTOL}; one process's twice {got['again']:.4e}, "
            f"{got32['again']:.4e})")


def data_parallel(card: str, kernels: dict) -> dict:
    """Phase 14: the released Clas recipe at full width (ResNet34 in bf16,
    224 x 224, global batch 128, CCV 4 x 288 x 50, the hand_obj refiner),
    synth-only through ``train.main`` (CONFIG_LEN_TRAIN 512: 4 steps,
    VAL_LEN 128, 1 epoch), run by 2 processes joined with ``--multihost``
    on the one card (gloo), then by 1 process with ``--multihost`` (NCCL,
    one rank), then ``--resume`` of the 2-rank run by 2 processes, then the
    2-rank run in float32. Each process is a
    ``--dp-worker`` of this script; B1's hold on each rank's rows goes into
    ``kernels``. -> B1's launches by run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        cfg_path = _dp_config(tmp)
        t0 = time.perf_counter()
        two = _dp_launch(2, tmp, "two", cfg=cfg_path)
        one = _dp_launch(1, tmp, "one", cfg=cfg_path)
        resumed = _dp_launch(2, tmp, "resume", resume=two[0]["dump_path"])
        two32 = _dp_launch(2, tmp, "two_f32", cfg=_dp_config(tmp, "float32"))
        wall = time.perf_counter() - t0
        got = _dp_check(two, one, "gloo", ["cuda:0", "cuda:0"], "phase 14")
        got32 = _dp_check(two32, None, "gloo", ["cuda:0", "cuda:0"], "phase 14 float32")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels["raster_uv"]["max_abs_err"] = max(kernels["raster_uv"]["max_abs_err"],
                                              got["uv_err"], got32["uv_err"])
    for r, rec in enumerate(resumed):
        check(rec["restored"] == dict(two[r]["saved"], epoch=1),
              f"phase 14 resume rank {r}: restored {rec['restored']}, saved {two[r]['saved']}")
    print(f"phase 14, data parallel ({card}): released Clas recipe synth-only, 4 steps of a "
          f"global 128, 1 val batch; 4 runs in {wall:.2f} s. 2 ranks (gloo, one card): "
          f"params, buffers, Adam, the weight map and every draw bit-equal across ranks; each "
          f"rank {two[0]['launches']['raster_uv']} uv launches at B = 64, B1 bit-equal to its "
          f"twin on each rank's first batch; {_rate(two[0]):.2f} train img/s (rank 0's epoch, "
          f"{two[0]['seconds']:.2f} s in train.main); final_loss {two[0]['final_loss']}. "
          f"1 process (NCCL): {_rate(one[0]):.2f} train img/s, final_loss "
          f"{one[0]['final_loss']}; {_dp_line(got, got32)}. 2-rank --resume restored epoch 1 "
          f"bit-equal on both ranks.",
          flush=True)
    return {"two_rank_0": two[0]["launches"], "two_rank_1": two[1]["launches"],
            "one": one[0]["launches"]}


def data_parallel_cards(card: str, n: int) -> None:
    """``--dp-cards``: phase 14's recipe run by one rank a card over all
    ``n`` cards (NCCL), then by 1 process, in turns (N, 1, N, 1), then by
    N in float32; the same checks as phase 14 and each run's train img/s."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_cards_")
    try:
        cfg_path = _dp_config(tmp)
        ranks32 = _dp_launch(n, tmp, "n_f32", cfg=_dp_config(tmp, "float32"))
        got32 = _dp_check(ranks32, None, "nccl", [f"cuda:{r}" for r in range(n)],
                          "--dp-cards float32")
        for i in range(2):
            ranks = _dp_launch(n, tmp, f"n{i}", cfg=cfg_path)
            one = _dp_launch(1, tmp, f"one{i}", cfg=cfg_path)
            got = _dp_check(ranks, one, "nccl", [f"cuda:{r}" for r in range(n)],
                            f"--dp-cards {i}")
            print(f"data parallel over {n} cards ({card}), turn {i}: released Clas "
                  f"recipe synth-only, 4 steps of a global 128, 1 val batch; {n} ranks (NCCL, "
                  f"one card each): state and draws bit-equal across ranks, "
                  f"{ranks[0]['launches']['raster_uv']} uv launches a rank at B = {128 // n}, "
                  f"B1 bit-equal to its twin on each rank's first batch; {_rate(ranks[0]):.2f} "
                  f"train img/s (rank 0's epoch 0), final_loss {ranks[0]['final_loss']}; "
                  f"1 process: {_rate(one[0]):.2f} train img/s, final_loss "
                  f"{one[0]['final_loss']}; {_dp_line(got, got32)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trainers(card: str) -> None:
    """Phase 15: ``artiboost_torch.scripts.train_refiner.main`` (100 steps,
    --batch 256 --obj_points 2048) and ``train_iknet.main`` (200 steps) on
    the card, each writing its npz into a temporary directory; the losses
    finite and the mean of the last 10 steps below that of the first 10;
    each npz loaded back in the port and equal to the trained net."""
    import torch

    from artiboost_torch.artiboost.refiner import RefineNet, build_refiner
    from artiboost_torch.mano.model import get_mano_model
    from artiboost_torch.postprocess.fitting import load_iknet_params
    from artiboost_torch.postprocess.iknet import IKNet
    from artiboost_torch.scripts import train_iknet, train_refiner
    from artiboost_torch.utils.convert import load_flax_npz, refinenet_from_flax

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainers_")
    try:
        res = {
            "refiner": train_refiner.main(["--steps", "100", "--batch", "256", "--obj_points",
                                           "2048", "--out", os.path.join(tmp, "refinenet.npz"),
                                           "--log_freq", "25"]),
            "iknet": train_iknet.main(["--steps", "200", "--out", os.path.join(tmp, "iknet.npz"),
                                       "--log_freq", "50"])}
        for name, r in res.items():
            losses = [m["loss"] for m in r["losses"]]
            check(all(math.isfinite(v) for v in losses), f"phase 15 {name}: losses {losses}")
            head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
            check(tail < head, f"phase 15 {name}: the last 10 steps' loss {tail} is not below "
                               f"the first 10's {head}")
            r["head"], r["tail"] = head, tail
        net = RefineNet()
        net.load_state_dict(refinenet_from_flax(load_flax_npz(res["refiner"]["out"])["params"]))
        trained = res["refiner"]["net"].state_dict()
        check(all(torch.equal(v, trained[k].cpu()) for k, v in net.state_dict().items()),
              "phase 15: refinenet.npz does not hold the trained RefineNet")
        build_refiner({"TYPE": "hand_obj", "PRETRAINED": res["refiner"]["out"]},
                      get_mano_model(device="cuda"))
        ik = IKNet()
        ik.load_state_dict(load_iknet_params(res["iknet"]["out"]))
        trained = res["iknet"]["net"].state_dict()
        check(all(torch.equal(v, trained[k].cpu()) for k, v in ik.state_dict().items()
                  if not k.endswith("num_batches_tracked")),
              "phase 15: iknet.npz does not hold the trained IKNet")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r, k = res["refiner"], res["iknet"]
    print(f"phase 15, trainers ({card}): train_refiner 100 steps at --batch 256 --obj_points "
          f"2048: {r['ms_per_step']:.3f} ms a step, loss {r['head']:.6f} (first 10) -> "
          f"{r['tail']:.6f} (last 10); held-out recovery: scrambled {r['scrambled_mm']:.3f} mm "
          f"-> refined {r['refined_mm']:.3f} mm. train_iknet 200 steps at B 256: "
          f"{k['ms_per_step']:.3f} ms a step, loss {k['head']:.6f} -> {k['tail']:.6f}; fitting "
          f"residual with the trained warm start {k['fit_err_mm']:.3f} mm. Both npz load "
          f"back equal.", flush=True)



# phase 16: the host waits that stay in a train step that does not log
# (PERF.md lists them): each is a file:line where sync debug mode warns
ALLOWED_WAITS_PER_STEP = 0
ORDER_STEPS = range(2, 7)  # the train steps of epoch 0 whose waits are counted


def order_config():
    """Phase 8's run (the released Clas recipe, synth-only: CONFIG_LEN_TRAIN
    1024, 8 steps of 128; VAL_LEN 2 x 128; EVAL_FREQ 1, VAL_START_EPOCH 0)
    without its TEST split."""
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["DATASET"].pop("TEST", None)
    cfg["MANAGER"].update(CONFIG_LEN_TRAIN=1024, VAL_LEN=2 * 128)
    cfg["TRAIN"].update(EVAL_FREQ=1, VAL_START_EPOCH=0)
    return cfg


def order_run(pipeline: bool, trace_dir: Optional[str] = None, count_waits: bool = False) -> dict:
    """``train.run`` of ``order_config`` for 2 epochs with PIPELINE_SYNTH
    ``pipeline`` -> its per-step losses, the weight map after the last
    reweight, the first two synth batches' images (on the host), epoch 1's
    train img/s, the trace's path and, with ``count_waits``, every host
    wait that sync debug mode reports in epoch 0's ORDER_STEPS, by the
    file:line of the port's innermost frame that made it (and the line
    that warned, where that is torch's)."""
    import collections
    import contextlib
    import traceback
    import warnings

    import torch

    from artiboost_torch import train
    from artiboost_torch.artiboost.loader import ArtiBoostLoader

    cfg = order_config()
    cfg["TRAIN"]["PIPELINE_SYNTH"] = pipeline
    first, state = [], {"epoch": 0, "bidx": 0}
    orig = {"part": ArtiBoostLoader.synth_part, "trace": train.profiling.step_trace,
            "epoch": train.train_epoch}

    def synth_part(self, sidx):
        out = orig["part"](self, sidx)
        if len(first) < 2:
            first.append(out["image"].clone())
        return out

    @contextlib.contextmanager
    def step_trace(name, step):
        on = count_waits and state["epoch"] == 0 and state["bidx"] in ORDER_STEPS
        if on:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with orig["trace"](name, step):
                yield
        finally:
            if on:
                torch.cuda.set_sync_debug_mode(0)
            state["bidx"] += 1

    def train_epoch(*args, **kw):
        state.update(epoch=kw.get("epoch", 0), bidx=0)
        return orig["epoch"](*args, **kw)

    waits = collections.Counter()
    package = os.path.join(REPO, "artiboost_torch")

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        if any(f.name == "set_sync_debug_mode" for f in stack[-3:]):
            # raised by the call that switches the mode on at a step's start
            # (seen once, in one order only), not by the step's work
            waits["(the switch of sync debug mode)"] += 1
            return
        ours = [f for f in stack if f.filename.startswith(package)]
        site = f"{os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}" if ours else "?"
        if not filename.startswith(package):
            site += f" (via {os.path.basename(os.path.dirname(filename))}/" \
                    f"{os.path.basename(filename)}:{lineno})"
        waits[site] += 1

    ArtiBoostLoader.synth_part, train.profiling.step_trace = synth_part, step_trace
    train.train_epoch = train_epoch
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            out = train.run(cfg, epochs=2, device="cuda", test_freq=0,
                            profile=(trace_dir, 6) if trace_dir else None)
            torch.cuda.synchronize()
    finally:
        ArtiBoostLoader.synth_part, train.profiling.step_trace = orig["part"], orig["trace"]
        train.train_epoch = orig["epoch"]
    hist = out["history"]
    traces = sorted(os.path.join(trace_dir, n) for n in os.listdir(trace_dir)) if trace_dir \
        else []
    return {"losses": [v for r in hist for v in r["train"]["final_loss"]],
            "weight_map": out["loader"].ccv.sample_weight_map.cpu(),
            "first": [t.cpu() for t in first], "waits": waits,
            "steps": sum(r["train"]["steps"] for r in hist),
            "val_batches": sum(r.get("val", {}).get("batches", 0) for r in hist),
            "rate": hist[1]["train"]["images"] / hist[1]["train"]["seconds"],
            "trace": traces[-1] if traces else None}


def order_worker(spec: dict):
    """``chip_smoke.py --order-worker <json>``: phase 16's deterministic runs
    in a process of their own (cuBLAS reads CUBLAS_WORKSPACE_CONFIG when it
    starts): cuDNN and torch's deterministic algorithms, then one run per
    entry of ``spec["orders"]``; writes their losses and weight maps to
    ``spec["out"]``."""
    import torch

    sys.path.insert(0, REPO)
    os.chdir(REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = [order_run(p) for p in spec["orders"]]
    torch.save([{k: r[k] for k in ("losses", "weight_map", "first")} for r in runs], spec["out"])


def pipelined_order(card: str, read_counts, zero_counts) -> dict:
    """Phase 16: phase 8's run pipelined (the default) and with
    PIPELINE_SYNTH false, in this process, neither waiting at a stage:
    epoch 1's train img/s, the trace's figures (epoch 0's steps 1-6) and
    the host waits of epoch 0's steps 2-6 under sync debug mode; B1 once a
    synth batch in each; the first two synth batches byte-equal. Then, in
    a process with cuDNN and torch deterministic, a pipelined run and two
    unpipelined ones: the per-step losses and the weight maps of the two
    orders bit-equal, or within the two unpipelined runs' own spread.
    -> the pipelined run's launches."""
    import torch

    got, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_order_")
    try:
        for name, pipeline in (("pipelined", True), ("unpipelined", False)):
            zero_counts()
            got[name] = order_run(pipeline, os.path.join(tmp, name), count_waits=True)
            launches[name] = read_counts()
            got[name]["fig"] = trace_figures(got[name]["trace"])
        spec = {"orders": [True, False, False], "out": os.path.join(tmp, "det.pt")}
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--order-worker",
                              json.dumps(spec)], env=env, capture_output=True, text=True,
                             timeout=600)
        check(res.returncode == 0, f"phase 16 deterministic runs exited {res.returncode}:\n"
                                   f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        det = torch.load(spec["out"], weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p, u = got["pipelined"], got["unpipelined"]
    for r in (p, u):
        check(r["steps"] == 16 and r["val_batches"] == 4,
              f"phase 16 ran {r['steps']} steps and {r['val_batches']} val batches")
    want = {"raster_uv": 16 + 4, "raster_rgb": 0, "raster_rgb_binned": 0}
    check(launches["pipelined"] == launches["unpipelined"] == want,
          f"phase 16 launches {launches}, expected one uv a synth batch: {want}")
    check(all(torch.equal(a, b) for a, b in zip(p["first"], u["first"])) and len(p["first"]) == 2,
          "phase 16: the two orders' first synth batches differ")
    for r in (p, u):
        check(all(math.isfinite(v) for v in r["losses"]), f"phase 16: losses {r['losses']}")

    def gap(a, b):
        return (max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
                float((a["weight_map"] - b["weight_map"]).abs().max()))

    same = gap(det[0], det[1]) == (0.0, 0.0)
    spread, apart = gap(det[1], det[2]), gap(det[0], det[1])
    n_steps = len(ORDER_STEPS)
    per_step = {k: sum(n for site, n in r["waits"].items() if not site.startswith("(")) / n_steps
                for k, r in got.items()}
    print(f"phase 16, PIPELINE_SYNTH true against false ({card}): phase 8's run (released Clas "
          f"recipe, synth-only, 2 epochs of 8 steps of 128, 2 val batches each), no stage "
          f"waits; launches {launches['pipelined']} in each; the first two synth batches "
          f"byte-equal; deterministic runs: pipelined against unpipelined "
          f"{'bit-equal' if same else 'apart by %r' % (apart,)} (losses, weight map), two "
          f"unpipelined runs apart by {spread}; in the default mode the orders' losses part by "
          f"{gap(p, u)[0]:.3e} and their weight maps by {gap(p, u)[1]:.3e}", flush=True)
    for name, r in got.items():
        print(f"  {name} ({card}): train {r['rate']:.2f} img/s in epoch 1; trace "
              f"{trace_line(r['fig'])}", flush=True)
        print(f"  {name} ({card}): {per_step[name]:.1f} host waits a train step (sync debug "
              f"mode over epoch 0's steps {ORDER_STEPS.start}-{ORDER_STEPS.stop - 1}): "
              + (", ".join(f"{site} x{n}" for site, n in r["waits"].most_common()) or "none"),
              flush=True)
    check(same or (apart[0] <= spread[0] and apart[1] <= spread[1]),
          f"phase 16: deterministic pipelined and unpipelined runs part by {apart} (losses, "
          f"weight map), beyond two unpipelined runs' {spread}")
    check(per_step["pipelined"] <= ALLOWED_WAITS_PER_STEP,
          f"phase 16: {per_step['pipelined']} host waits a step in the pipelined run, "
          f"{ALLOWED_WAITS_PER_STEP} allowed: {dict(p['waits'])}")
    return launches["pipelined"]


def mining_scripts(card: str, read_counts, zero_counts) -> dict:
    """Phase 17: ``scripts.mining_planted --plant noise`` (1 seed, 2 epochs,
    ``method_1`` and ``uniform``) and ``scripts.mining_ab`` (1 seed, 2
    epochs, its three methods) on config/mining_ab.yaml at its size: finite
    values, ``uniform``'s mass ratio exactly 1.000, B1 launched. -> the
    launches of both."""
    import torch

    from artiboost_torch.scripts import mining_ab, mining_planted

    zero_counts()
    t0 = time.perf_counter()
    planted = mining_planted.main(["--plant", "noise", "--epochs", "2", "--seeds", "1"])
    ab = mining_ab.main(["--epochs", "2", "--seeds", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = planted["rows"] + ab["rows"]

    def finite(row):
        vals = [v for v in row.values() if isinstance(v, float)]
        vals += [v for v in row.get("val_epe_dist_mm", {}).values()]
        return all(math.isfinite(v) for v in vals)

    check(len(rows) == 5 and all(finite(r) for r in rows), f"phase 17 rows {rows}")
    uni = [r for r in planted["rows"] if r["method"] == "uniform"]
    check(len(uni) == 1 and uni[0]["mass_ratio_vs_uniform"] == 1.0,
          f"phase 17: uniform's mass ratio {uni}")
    check(launches["raster_uv"] > 0, f"phase 17 launches {launches}: B1 did not launch")
    m1 = next(r for r in planted["rows"] if r["method"] == "method_1")
    print(f"phase 17, mining scripts ({card}): mining_planted --plant noise (1 seed, 2 epochs) "
          f"and mining_ab (1 seed, 2 epochs) in {wall:.2f} s; launches {launches}; method_1's "
          f"mass ratio {m1['mass_ratio_vs_uniform']}, uniform's "
          f"{uni[0]['mass_ratio_vs_uniform']}", flush=True)
    return launches


EVAL_CONFIGS = ("eval_ho3dv2_regbased_artiboost", "eval_ho3dv3_clasbased_artiboost",
                "eval_ho3dv3_clasbased_sym_artiboost", "eval_dexycb_clasbased_sym_artiboost")


def other_eval_configs(card: str, real: dict, read_counts, zero_counts) -> dict:
    """Phase 13b: ``submit_reload.main`` on the four other released
    evaluation configs at full width (ResNet34, 224 x 224, batch 128), a
    random init each (no checkpoint: the configs' released files are
    absent; where a config's BACKBONE.PRETRAINED asks for it, the ImageNet
    ResNet34 phase 11 wrote), ``--submit_dump --postprocess_draw``: HO3D v2 on phase 11's
    evaluation split (160 frames), HO3D v3 on an evaluation split of 128
    frames and DexYCB on an s0 test split of 128 frames, both written
    here beside phase 11's (``datasets/layouts.py``). Each dump has a row a frame, DexYCB's
    is ``pred_dexycb.json`` with a finite AR, and each drawn overlay tile
    launched B2 once. -> the launches of the four."""
    import numpy as np
    import torch
    import yaml

    from artiboost_torch import submit_reload
    from artiboost_torch.datasets import layouts
    from artiboost_torch.utils.config import load_config

    tmp = real["root"]
    rng = np.random.RandomState(13)
    layouts.write_ho3d(real["data"], "test", {"SM1": 64, "MPM10": 64}, REAL_OBJS, rng,
                       version="v3", n_images=8)
    layouts.write_dexycb(real["data"], 3, 5, 1, rng, test_frames=64)  # s0 test: 2 x 64 frames
    total, lines = {}, []
    try:
        os.chdir(tmp)
        for name in EVAL_CONFIGS:
            cfg = load_config(os.path.join(REPO, "config_eval", f"{name}.yaml"))
            for split in cfg["DATASET"].values():
                split["DATA_ROOT"] = real["data"]
            with open(f"{name}.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            draw_dir = os.path.join(tmp, f"draw_{name}")
            zero_counts()
            t0 = time.perf_counter()
            out = submit_reload.main(["--cfg", f"{name}.yaml", "--exp_id", name, "--submit_dump",
                                      "--postprocess_draw", "--postprocess_draw_path", draw_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            kind = cfg["DATASET"]["TEST"]["TYPE"].lower()
            n = {"ho3d": real["n_test"], "ho3dv3": 128, "dexycb": 128}[kind]
            check(out["pred_path"].endswith(f"pred_{kind}.json")
                  and out["weights"] in ("random init", "ARCH.PRETRAINED"),
                  f"phase 13b {name}: {out['pred_path']}, weights {out['weights']}")
            with open(out["pred_path"]) as f:
                xyz, verts = json.load(f)
            check(len(xyz) == len(verts) == n and all(len(j) == 21 for j in xyz),
                  f"phase 13b {name}: {len(xyz)} joint and {len(verts)} vert rows, {n} frames")
            tiles = 16 * min(out["batches"], 4)
            pngs = sorted(os.listdir(draw_dir))
            check(len(pngs) == min(out["batches"], 4)
                  and launches == {"raster_uv": 0, "raster_rgb": tiles, "raster_rgb_binned": 0},
                  f"phase 13b {name}: overlays {pngs}, launches {launches}, expected {tiles} rgb")
            m = out["measures"]
            check(all(math.isfinite(v) for metric in m.values() for v in metric.values()),
                  f"phase 13b {name}: measures {m}")
            if kind == "dexycb":
                ar = m["AR"]
                check(all(0.0 <= v <= 1.0 for k, v in ar.items() if k.startswith("AR")),
                      f"phase 13b {name}: AR {ar}")
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            lines.append(f"  {name} ({card}): {n} frames in {out['batches']} batches of 128 in "
                         f"{wall:.2f} s, {os.path.basename(out['pred_path'])} of {len(xyz)} rows "
                         f"and its zip, {len(pngs)} overlay grids; launches {launches}; "
                         + (f"AR {m['AR']['AR_MSSD']:.4f} (MSSD)" if kind == "dexycb" else
                            f"Mean3DEPE joints {m['Mean3DEPE']['joints_3d_abs_mepe']:.2f} mm"))
    finally:
        os.chdir(REPO)
    print(f"phase 13b, submission of the four other evaluation configs ({card}), random init:",
          flush=True)
    for line in lines:
        print(line, flush=True)
    return total

def main():
    t_smoke = time.perf_counter()
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
    timer4 = StageTimer(dev, sync=True)  # per-stage ms: each stage waits for its device work
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
    timer5 = StageTimer(dev, sync=True)
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
    for stage in ("dataset init", "pose sweep", "real wait", "real batch", "synth batch",
                  "train step", "forward", "metric+mining"):
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

    # ---- 8. the released entry point at full width ----
    launches8 = released_entry_point(card, read_counts, zero_counts)

    # ---- 9 and 10. the other two released recipes at full width ----
    launches9 = other_recipe(9, "ho3dv2_regbased_artiboost", card, read_counts, zero_counts)
    launches10 = other_recipe(10, "dexycb_clasbased_sym_artiboost", card, read_counts,
                              zero_counts)

    real_dir = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        # ---- 11. the released recipe on real-layout data at full width ----
        launches11, real = real_data_recipe(card, kernels, hold, read_counts, zero_counts,
                                            real_dir)

        # ---- 12. the synth options at full width ----
        launches12 = synth_options(card, hold, read_counts, zero_counts)

        # ---- 13. the submission entry point on phase 11's files and checkpoint ----
        launches13 = submission(card, real, hold, read_counts, zero_counts)
        launches13b = other_eval_configs(card, real, read_counts, zero_counts)
    finally:
        shutil.rmtree(real_dir, ignore_errors=True)

    # ---- 14. data parallel: 2 ranks on the card against 1 process ----
    launches14 = data_parallel(card, kernels)

    # ---- 15. the RefineNet and IKNet trainers ----
    trainers(card)

    # ---- 16. the pipelined train step against the unpipelined order ----
    launches16 = pipelined_order(card, read_counts, zero_counts)

    # ---- 17. the mining experiment scripts, short ----
    launches17 = mining_scripts(card, read_counts, zero_counts)

    rows = []
    per_rank14 = [launches14["two_rank_0"], launches14["two_rank_1"]]
    main_path = {"8": launches8, "9": launches9, "10": launches10, "11": launches11,
                 "12": launches12,
                 "14": {k: sum(c[k] for c in per_rank14) for k in per_rank14[0]},
                 "16": launches16, "17": launches17}
    for name, src_line, phases in (("raster_uv", 222, main_path),
                                   ("raster_rgb", 201, dict(main_path, **{
                                       "13": launches13, "13b": launches13b})),
                                   ("raster_rgb_binned", 272, {"6": launches6})):
        k = kernels[name]
        by_phase = {p: counts[name] for p, counts in phases.items()}
        rows.append({"name": name, "route": "cuda", "source": "artiboost_torch/csrc/raster.cu",
                     "replaces": f"artiboost_tpu/ops/rasterizer_pallas.py:{src_line}",
                     "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                     "launches_phase14_by_rank": [c[name] for c in per_rank14],
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(f"chip_smoke: phases 1-17 passed in {time.perf_counter() - t_smoke:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def dp_cards_main():
    """``python3 chip_smoke.py --dp-cards``: data parallelism over every card
    of the machine, one rank a card (``data_parallel_cards``)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("--dp-cards needs two CUDA cards or more")
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    from artiboost_torch.ops.rasterizer_cuda import raster_uv

    raster_uv.build()  # once, before the ranks start
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = ", ".join(sorted(set(smi.stdout.strip().splitlines())))
    data_parallel_cards(card, torch.cuda.device_count())
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":
        dp_worker(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == "--order-worker":
        order_worker(json.loads(sys.argv[2]))
    elif sys.argv[1:] == ["--dp-cards"]:
        dp_cards_main()
    else:
        main()
