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
     its twin and timed on a train batch at these assets (F, atlas).
Every launch counter is zeroed just before phases 4 to 11 and read just
after each. TF32 is off. The lines before the last: the kernel table as one
JSON object (B1 and B2 launches from phases 8 to 11, summed and by phase,
B3 launches from phase 6) and the card's name and power limit; the last
line: the ok JSON.

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


def _union_ms(intervals, lo, hi) -> float:
    """ms covered by the union of (start, end) intervals (us) within [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_figures(path: str) -> dict:
    """Phase 8's figures from its Chrome trace, over train steps 1 to the
    last traced one (step 0 holds first-use costs): the device idle share
    (1 - the union of kernel, memcpy and memset intervals over the window's
    wall time); per ``artiboost/train_step`` range its wall time, the host
    time until the stage's ``cudaDeviceSynchronize`` and the device's busy
    time inside it; the host time in ``raster/prepare_raster`` against the
    ``raster_uv_kernel`` time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def spans(cat, pred, lo=-math.inf, hi=math.inf):
        """Events of category ``cat`` whose name passes ``pred``, inside [lo, hi]."""
        return [e for e in events if e.get("cat") == cat and pred(e["name"])
                and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]

    def mean(xs):
        return sum(xs) / len(xs)

    steps = sorted(spans("user_annotation", lambda n: n.startswith("train#")), key=lambda e: e["ts"])
    check(len(steps) >= 2, f"the trace holds {len(steps)} train steps")
    lo, hi = steps[1]["ts"], max(e["ts"] + e["dur"] for e in steps[1:])
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _union_ms(device, lo, hi)
    wall = (hi - lo) / 1e3
    split = []
    for r in spans("user_annotation", lambda n: n == "artiboost/train_step", lo, hi):
        a, b = r["ts"], r["ts"] + r["dur"]
        wait = sum(e["dur"] for e in spans("cuda_runtime", lambda n: "Synchronize" in n, a, b))
        split.append((r["dur"] / 1e3, (r["dur"] - wait) / 1e3, _union_ms(device, a, b)))
    prep = [e["dur"] / 1e3 for e in spans("user_annotation",
                                          lambda n: n == "raster/prepare_raster", lo, hi)]
    uv = [e["dur"] / 1e3 for e in spans("kernel", lambda n: "raster_uv_kernel" in n, lo, hi)]
    check(split and prep and uv, f"the trace window lacks train_step ({len(split)}), "
          f"prepare_raster ({len(prep)}) or raster_uv_kernel ({len(uv)}) events")
    return {"steps": len(steps) - 1, "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "step_wall_ms": mean([x[0] for x in split]), "step_host_ms": mean([x[1] for x in split]),
            "step_device_ms": mean([x[2] for x in split]), "n_step": len(split),
            "prep_ms": mean(prep), "n_prep": len(prep), "uv_ms": mean(uv), "n_uv": len(uv)}


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
        print(f"  stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
              f"{timer.seconds[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")
    print(f"trace ({card}), train steps 1-{fig['steps']} of epoch 0, {fig['wall_ms']:.3f} ms: "
          f"device busy {fig['busy_ms']:.3f} ms, idle share {fig['idle_share']:.4f}; train step "
          f"(mean of {fig['n_step']}): wall {fig['step_wall_ms']:.3f} ms, host until its "
          f"synchronize {fig['step_host_ms']:.3f} ms, device busy {fig['step_device_ms']:.3f} ms; "
          f"prepare_raster host {fig['prep_ms']:.3f} ms a call ({fig['n_prep']} calls) against "
          f"raster_uv_kernel {fig['uv_ms']:.4f} ms a launch ({fig['n_uv']} launches)", flush=True)
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
        print(f"  stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
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


def real_data_recipe(card: str, kernels: dict, hold, read_counts, zero_counts) -> dict:
    """Phase 11: ``artiboost_torch.train.main`` on the released recipe with
    its data on disk (``write_real_layout`` in a temporary working
    directory), the config unchanged but DATA_ROOT, EVAL_FREQ 1 and
    VAL_START_EPOCH 0: 2 epochs of 6 mixed steps (80 HO3D + 48 synth), the
    val sweep of the released VAL_LEN, a TEST pass over the 160 evaluation
    frames after each epoch, a trace of epoch 0 through step 6. Holds B1 on
    a train batch at these assets against its twin and times it. Everything
    it writes is removed. -> the launches of the run."""
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
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

    def device_half(self, host):
        if self.data_split == "test":
            records["test_idx"].append(list(host.sample_idx))
        return orig["device_half"](self, host)

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
        del out, loader
    finally:
        os.chdir(REPO)
        train.union_concat, train.load_arch_pretrained = orig["union"], orig["pretrained"]
        HODataset.device_half, renderer.rasterize_batch_uv = orig["device_half"], orig["raster"]
        logging.getLogger("artiboost_torch").removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)  # the experiment directory with it
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
        print(f"  stage {stage}: {timer.seconds[stage] * 1e3:.2f} ms total, "
              f"{timer.seconds[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")
    print(f"  trace ({card}), train steps 1-{fig['steps']} of epoch 0, {fig['wall_ms']:.3f} ms: "
          f"device busy {fig['busy_ms']:.3f} ms, idle share {fig['idle_share']:.4f}; train step "
          f"wall {fig['step_wall_ms']:.3f} ms, host until its synchronize "
          f"{fig['step_host_ms']:.3f} ms, device busy {fig['step_device_ms']:.3f} ms", flush=True)
    inp = prepare_raster(*args, **kw)
    hold(raster_uv, inp, "phase 11 train batch at the YCB assets")
    print(f"  raster_uv at the real assets: F={inp.order.shape[-1]} (LOD of the 2048-vertex "
          f"meshes and the hand), texture atlas {atlas}; stand-in figure of phase 3: "
          f"{kernels['raster_uv']['ms']:.4f} ms", flush=True)
    timing(raster_uv, inp, 3, card, torch)
    del inp
    return launches


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

    # ---- 11. the released recipe on real-layout data at full width ----
    launches11 = real_data_recipe(card, kernels, hold, read_counts, zero_counts)

    rows = []
    main_path = {"8": launches8, "9": launches9, "10": launches10, "11": launches11}
    for name, src_line, phases in (("raster_uv", 222, main_path),
                                   ("raster_rgb", 201, main_path),
                                   ("raster_rgb_binned", 272, {"6": launches6})):
        k = kernels[name]
        by_phase = {p: counts[name] for p, counts in phases.items()}
        rows.append({"name": name, "route": "cuda", "source": "artiboost_torch/csrc/raster.cu",
                     "replaces": f"artiboost_tpu/ops/rasterizer_pallas.py:{src_line}",
                     "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
