#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``artiboost_torch``) on one GPU.

Phases, each fatal on failure:
  1. device line (nvidia-smi name and power limit, torch device name);
  2. build every CUDA kernel of the path from ``artiboost_torch/csrc``;
  3. each kernel against its plain PyTorch twin on the card, bit for bit:
     the seeded scenes of ``artiboost_torch/ops/raster_scenes.py`` (random
     triangles at F = 60 and F = 700, invalid faces, a two-triangle depth tie),
     and one main-path scene batch (B = 128 at 112x112 from the port's own
     synthetic geometry); kernel and plain times at that shape;
  4. the synthesis-and-mining slice at full width (config
     ho3dv2_clasbased_artiboost.yaml: ResNet34, 224x224, batch 128, CCV
     4 x 288 x 50, method_1; REFINER null, VAL_LEN 8 x 128) for 2 epochs
     through ``artiboost_torch.train.run`` in float32 (TF32 off), with
     every launch counter zeroed just before and read just after.
The lines before the last: the kernel table as one JSON object and the
card's name and power limit; the last line: the ok JSON.

Usage: python3 chip_smoke.py   (from the repository root; needs one CUDA card)
"""
import json
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


def compare_raster(inp, torch):
    """Kernel vs plain twin on one prepared input: -> (max abs err, equal)."""
    from artiboost_torch.ops.rasterizer_cuda import (
        finish_uv_raster,
        rasterize_batch_uv_torch,
        raster_uv,
    )

    args = (inp.ranges, inp.geom, inp.col, inp.height, inp.width)
    k = finish_uv_raster(inp, *raster_uv(*args))
    p = finish_uv_raster(inp, *rasterize_batch_uv_torch(*args))
    torch.cuda.synchronize()
    err, equal = 0.0, True
    for a, b in zip(k, p):
        equal &= bool(torch.equal(a, b))
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err, equal


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
    import numpy as np

    from artiboost_torch.artiboost import renderer
    from artiboost_torch.ops.raster_scenes import raster_check_scenes
    from artiboost_torch.ops.rasterizer_cuda import (
        TILE_PX,
        prepare_uv_raster,
        rasterize_batch_uv_torch,
        raster_uv,
    )
    from artiboost_torch.train import StageTimer, run
    from artiboost_torch.utils.config import load_config

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
    print(f"build: raster_uv.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in raster_uv.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain twins ----
    max_err = 0.0
    for name, sc in raster_check_scenes().items():
        t = {k: torch.from_numpy(sc[k]).to(dev) for k in ("verts", "attrs", "faces", "valid")}
        for cull in (False, True):
            inp = prepare_uv_raster(t["verts"], t["attrs"], t["faces"], t["valid"],
                                    sc["H"], sc["W"], cull_backfaces=cull)
            err, equal = compare_raster(inp, torch)
            max_err = max(max_err, err)
            print(f"raster {name} cull={cull}: bit-equal={equal} max_abs_err={err}", flush=True)
            check(equal, f"raster kernel differs from its plain twin on {name}")

    cfg = load_config(os.path.join(REPO, "config", "ho3dv2_clasbased_artiboost.yaml"))
    cfg["MANAGER"]["REFINER"] = {"TYPE": "null"}
    cfg["MANAGER"]["VAL_LEN"] = 8 * 128
    cfg["TRAIN"]["EVAL_FREQ"] = 1
    cfg["TRAIN"]["VAL_START_EPOCH"] = 0

    # one main-path scene batch: capture the raster call of one val batch
    from artiboost_torch.artiboost.loader import ArtiBoostLoader
    from artiboost_torch.train import slice_config

    probe = ArtiBoostLoader(cfg=slice_config(cfg), batch_size=128, seed=0, device=dev)
    probe.prepare_val()
    captured = {}
    orig = renderer.rasterize_batch_uv

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return orig(*args, **kw)

    renderer.rasterize_batch_uv = capture
    try:
        next(probe.iter_val())
    finally:
        renderer.rasterize_batch_uv = orig
    inp = prepare_uv_raster(*captured["args"], **captured["kw"])
    B, n_pix = inp.geom.shape[0], inp.height * inp.width
    err, equal = compare_raster(inp, torch)
    max_err = max(max_err, err)
    print(f"raster main-path batch B={B} {inp.height}x{inp.width} F={inp.order.shape[1]}: "
          f"bit-equal={equal} max_abs_err={err}", flush=True)
    check(equal, "raster kernel differs from its plain twin on the main-path batch")

    args = (inp.ranges, inp.geom, inp.col, inp.height, inp.width)
    ms = cuda_ms(lambda: raster_uv(*args), 50)
    plain_ms = cuda_ms(lambda: rasterize_batch_uv_torch(*args), 5)
    span = (inp.ranges[..., 1] - inp.ranges[..., 0]).double()  # (B, T) chunks scanned
    tile_pix = torch.clamp(n_pix - torch.arange(span.shape[1], device=dev) * TILE_PX,
                           0, TILE_PX).double()
    chunk_px = float((span * tile_pix).sum())
    mean_chunks = chunk_px / (B * n_pix)
    ops = chunk_px * 128 * RASTER_OPS_PER_LANE
    nbytes = sum(t.numel() * t.element_size() for t in (inp.ranges, inp.geom, inp.col)) \
        + 4 * B * n_pix * 4
    bound_ms = max(nbytes / H100_BYTES_PER_S, ops / H100_FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / H100_BYTES_PER_S > ops / H100_FP32_OPS_PER_S else "operations"
    print(f"raster timing ({card}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} (mean {mean_chunks:.3f} chunks/pixel, "
          f"{nbytes} bytes, {ops:.4g} ops)", flush=True)
    del probe

    # ---- 4. the slice at full width ----
    raster_uv.launches = 0
    timer = StageTimer(dev)
    t0 = time.perf_counter()
    out = run(cfg, epochs=2, device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = raster_uv.launches
    loader, evaluator = out["loader"], out["evaluator"]
    check(out["n_val_batches"] == 2 * 8, f"expected 16 val batches, ran {out['n_val_batches']}")
    check(launches == out["n_val_batches"],
          f"raster launches {launches} != synthetic batches rendered {out['n_val_batches']}")
    avg, seen = evaluator.metrics_list[0].get_averaged_maps()
    check(int(seen.sum()) > 0 and bool(torch.isfinite(avg[seen]).all()),
          "val EPE map is empty or not finite where seen")
    w = loader.ccv.sample_weight_map
    check(not bool(torch.all(w == 1.0)), "sample_weight_map did not change after step_eval")
    check(float(w.min()) >= 0.1 and float(w.max()) <= 10.0, "sample_weight_map left [0.1, 10]")
    secs = timer.seconds
    val_s = secs["synth batch"] + secs["forward"] + secs["metric+mining"]
    print(f"slice ({card}): 2 epochs in {wall:.2f} s, {out['n_val_images']} val images, "
          f"{out['n_val_images'] / val_s:.2f} img/s over the val pass; "
          f"{int(seen.sum())} triplets seen, mean EPE {float(avg[seen].mean()):.2f} mm, "
          f"weights [{float(w.min()):.4f}, {float(w.max()):.4f}]", flush=True)
    for stage in ("pose sweep", "synth batch", "forward", "metric+mining"):
        n = max(timer.calls[stage], 1)
        print(f"  stage {stage}: {secs[stage] * 1e3:.2f} ms total, "
              f"{secs[stage] * 1e3 / n:.3f} ms per call over {timer.calls[stage]} calls")

    kernels = [{
        "name": "raster_uv", "route": "cuda", "source": "artiboost_torch/csrc/raster_uv.cu",
        "replaces": "artiboost_tpu/ops/rasterizer_pallas.py:222",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
