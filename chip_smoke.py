#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``artiboost_torch``) on one GPU.

Phases, each fatal on failure:
  1. device line (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel of the path: ``artiboost_torch/csrc/raster.cu``
     holds both raster kernels (uv and Gouraud rgb);
  3. each kernel against its plain PyTorch twin on the card, bit for bit:
     the seeded scenes of ``artiboost_torch/ops/raster_scenes.py`` (random
     triangles at F = 60 and F = 700, invalid faces, a two-triangle depth
     tie) with back-face culling off and on; the uv kernel on one val batch
     of the main path (B = 128 at 112x112) and the rgb kernel on one
     SyntheticHO render chunk at full width (B = 16 at 512x512, hand plus
     an object of up to 1024 faces); kernel and plain times at those shapes;
  4. the val-and-mining slice at full width (config
     ho3dv2_clasbased_artiboost.yaml: ResNet34 in bfloat16, 224x224, batch
     128, CCV 4 x 288 x 50, method_1; REFINER null, VAL_LEN 8 x 128) for 2
     epochs without the train pass;
  5. the train pass at full width through ``artiboost_torch.train.run``:
     the same config with DATASET.TRAIN = SyntheticHO (RAW_SIZE 512,
     N_SAMPLES 640, so 80 real + 48 synth per batch and 8 steps per
     epoch), VAL_LEN 2 x 128, 2 epochs, EVAL_FREQ 1 / VAL_START_EPOCH 0;
     then the KEY_VALID masks of a mixed batch whose real half lacks the
     MANO keys.
Every launch counter is zeroed just before phases 4 and 5 and read just
after each. TF32 is off. The lines before the last: the kernel table as one
JSON object and the card's name and power limit; the last line: the ok JSON.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)
"""
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # non-tensor FP32, H100 SXM data sheet
RASTER_OPS_PER_LANE = 25        # pass-1 operations per (pixel, face)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel, finish, inp, torch):
    """Kernel vs its plain twin on one prepared input: -> (max abs err, equal)."""
    args = (inp.ranges, inp.geom, inp.col, inp.height, inp.width)
    k = finish(inp, *kernel(*args))
    p = finish(inp, *kernel.twin(*args))
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


def timing(kernel, inp, reps_plain: int, card: str, torch):
    """Kernel and twin times (CUDA events) and the bound at this input."""
    from artiboost_torch.ops.rasterizer_cuda import TILE_PX

    args = (inp.ranges, inp.geom, inp.col, inp.height, inp.width)
    ms = cuda_ms(lambda: kernel(*args), 50)
    plain_ms = cuda_ms(lambda: kernel.twin(*args), reps_plain)
    B, n_pix = inp.geom.shape[0], inp.height * inp.width
    span = (inp.ranges[..., 1] - inp.ranges[..., 0]).double()  # (B, T) chunks scanned
    tile_pix = torch.clamp(n_pix - torch.arange(span.shape[1], device=span.device) * TILE_PX,
                           0, TILE_PX).double()
    chunk_px = float((span * tile_pix).sum())
    ops = chunk_px * 128 * RASTER_OPS_PER_LANE
    nbytes = sum(t.numel() * t.element_size() for t in (inp.ranges, inp.geom, inp.col)) \
        + 4 * B * n_pix * 4  # four 32-bit output words per pixel
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FP32_OPS_PER_S
    bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    print(f"{kernel.name} timing ({card}): B={B} {inp.height}x{inp.width} F={inp.order.shape[1]}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"(mean {chunk_px / (B * n_pix):.3f} chunks/pixel, {nbytes} bytes, {ops:.4g} ops)",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def full_width_config():
    from artiboost_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["MANAGER"]["REFINER"] = {"TYPE": "null"}
    cfg["TRAIN"]["EVAL_FREQ"] = 1
    cfg["TRAIN"]["VAL_START_EPOCH"] = 0
    return cfg


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

    from artiboost_torch.artiboost import renderer
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.criterions import build_criterion
    from artiboost_torch.datasets.synthetic import build_dataset
    from artiboost_torch.metrics.evaluator import build_evaluator
    from artiboost_torch.metrics.val_metric import ValMetricMean3DEPE2
    from artiboost_torch.models.arch import build_arch
    from artiboost_torch.ops.raster_scenes import raster_check_scenes, rgb_attrs
    from artiboost_torch.ops.rasterizer_cuda import (
        finish_rgb_raster,
        finish_uv_raster,
        prepare_raster,
        raster_rgb,
        raster_uv,
    )
    from artiboost_torch.parallel.train_state import eval_step
    from artiboost_torch.train import StageTimer, run, slice_config, val_epoch
    from artiboost_torch.utils.batching import KEY_VALID, union_concat

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
    print(f"build: {raster_uv.library.source} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in raster_uv.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain twins ----
    kernels = {k.name: {"kernel": k, "max_abs_err": 0.0} for k in (raster_uv, raster_rgb)}
    finish = {"raster_uv": finish_uv_raster, "raster_rgb": finish_rgb_raster}

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
                hold(kernel, prepare_raster(t["verts"], attrs, t["faces"], t["valid"],
                                            sc["H"], sc["W"], cull_backfaces=cull),
                     f"{name} cull={cull}")

    cfg = full_width_config()
    val_cfg = dict(cfg, MANAGER=dict(cfg["MANAGER"], VAL_LEN=8 * 128))
    probe = ArtiBoostLoader(cfg=slice_config(val_cfg), batch_size=128, seed=0, device=dev)
    probe.prepare_val()
    args, kw = capture(renderer, "rasterize_batch_uv", lambda: next(probe.iter_val()))
    inp = prepare_raster(*args, **kw)
    hold(raster_uv, inp, f"main-path val batch B={inp.geom.shape[0]} {inp.height}x{inp.width}")
    kernels["raster_uv"].update(timing(raster_uv, inp, 5, card, torch))
    del probe

    synth_cfg = {"TYPE": "SyntheticHO", "DATA_SPLIT": "train", "AUG": True, "RAW_SIZE": 512,
                 "AUG_PARAM": {"SCALE_JIT": 0.1, "CENTER_JIT": 0.1, "MAX_ROT": 0.2}}
    args, kw = capture(renderer, "rasterize_batch_rgb", lambda: build_dataset(
        dict(synth_cfg, N_SAMPLES=16), cfg["DATA_PRESET"], device=dev))
    inp = prepare_raster(*args, **kw)
    hold(raster_rgb, inp, f"SyntheticHO chunk B={inp.geom.shape[0]} {inp.height}x{inp.width}")
    kernels["raster_rgb"].update(timing(raster_rgb, inp, 3, card, torch))

    # ---- 4. the val-and-mining slice (no train pass), bf16 ----
    raster_uv.launches = raster_rgb.launches = 0
    timer4 = StageTimer(dev)
    t0 = time.perf_counter()
    loader = ArtiBoostLoader(cfg=slice_config(val_cfg), batch_size=128, n_epochs=2, seed=1,
                             device=dev)
    evaluator = build_evaluator(val_cfg["EVALUATOR"], device=dev)
    criterion = build_criterion(val_cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        arch = build_arch(val_cfg["ARCH"], val_cfg["DATA_PRESET"]).to(dev)
    check(arch.model_list[0].backbone.conv1.compute_dtype == torch.bfloat16,
          "ARCH.DTYPE bfloat16 is not applied")
    loader.prepare()
    n_val = n_val_images = 0
    for epoch in range(2):
        loader.prepare()
        loader.prepare_val()
        res = val_epoch(loader, arch, criterion, evaluator, timer4)
        n_val, n_val_images = n_val + res["batches"], n_val_images + res["images"]
        loader.step_eval(epoch, evaluator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(n_val == 16, f"expected 16 val batches, ran {n_val}")
    check(raster_uv.launches == n_val and raster_rgb.launches == 0,
          f"phase 4 launches uv {raster_uv.launches} rgb {raster_rgb.launches}, "
          f"expected {n_val} and 0")
    vm = next(m for m in evaluator.metrics_list if isinstance(m, ValMetricMean3DEPE2))
    avg, seen = vm.get_averaged_maps()
    check(int(seen.sum()) > 0 and bool(torch.isfinite(avg[seen]).all()),
          "val EPE map is empty or not finite where seen")
    w = loader.ccv.sample_weight_map
    check(not bool(torch.all(w == 1.0)), "sample_weight_map did not change after step_eval")
    check(float(w.min()) >= 0.1 and float(w.max()) <= 10.0, "sample_weight_map left [0.1, 10]")
    val_s = sum(timer4.seconds[s] for s in ("synth batch", "forward", "metric+mining"))
    print(f"val slice ({card}): 2 epochs in {wall:.2f} s, {n_val_images} val images, "
          f"{n_val_images / val_s:.2f} img/s over the val pass (bf16); uv launches "
          f"{raster_uv.launches}; {int(seen.sum())} triplets seen, mean EPE "
          f"{float(avg[seen].mean()):.2f} mm", flush=True)
    for stage in ("synth batch", "forward", "metric+mining"):
        n = max(timer4.calls[stage], 1)
        print(f"  stage {stage}: {timer4.seconds[stage] * 1e3 / n:.3f} ms per call over "
              f"{timer4.calls[stage]} calls")
    del loader, arch, evaluator

    # ---- 5. the train pass at full width ----
    cfg["DATASET"]["TRAIN"] = dict(synth_cfg, N_SAMPLES=640)
    cfg["MANAGER"]["VAL_LEN"] = 2 * 128
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        init = build_arch(cfg["ARCH"], cfg["DATA_PRESET"]).model_list[0].state_dict()
    init = {k: v.clone() for k, v in init.items()}
    raster_uv.launches = raster_rgb.launches = 0
    timer5 = StageTimer(dev)
    t0 = time.perf_counter()
    out = run(cfg, epochs=2, device="cuda", model_state=init, timer=timer5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"raster_uv": raster_uv.launches, "raster_rgb": raster_rgb.launches}
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

    rows = []
    for name, src_line in (("raster_uv", 222), ("raster_rgb", 201)):
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": "artiboost_torch/csrc/raster.cu",
                     "replaces": f"artiboost_tpu/ops/rasterizer_pallas.py:{src_line}",
                     "launches": launches[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
