"""ArtiBoost training on PyTorch (counterpart of
``train/train_artiboost.py:224-381``).

``run`` builds the train and test datasets (``DATASET.TRAIN``,
``DATASET.TEST``; a real-data split whose data is absent is skipped as the
JAX package skips it: synth-only training, no test passes), the model, the
criterion, the evaluator, the test evaluator (the evaluator's metrics less
``ValMetric*``) and the ArtiBoostLoader, runs the startup ``prepare()``
(the reference runs it at startup AND at the top of every epoch, which
double-counts the occurrence map; kept for parity), then per epoch:
``prepare()``; the train epoch over mixed real+synth batches (the real half
from the dataset: its host half, geometry and image decode, made two
batches ahead by ``utils/prefetch.py``'s ``HostPipeline`` with ``workers``
decode threads, its device half, upload, flip and warp, on this thread;
the synth half rendered from the epoch's poses; the two joined over the
key union, then the train step, the evaluator fed with preds, batch and
losses); when ``should_val``, ``prepare_val()`` and the val
pass, which refills the evaluator; then ``step_eval()`` (the mining
reweight) from whatever the evaluator holds, so an epoch without a val
sweep mines from the train epoch as the JAX package does; then, every
``test_freq`` epochs, the TEST pass over the whole test split. With a
``Recorder`` (``utils/recorder.py``) each pass's measures go to
``evaluations/`` and, after ``step_eval``, a checkpoint to
``checkpoints/``; a resume restores the model, optimizer, schedule, RNG
states and the ArtiBoost state after the startup ``prepare()`` and goes on
from the first epoch the checkpoint had not completed (JAX
``train_artiboost.py:283, 309-316, 342-378``). ``evaluate`` runs one TEST
pass instead of training. A ``Summarizer`` (``utils/summarizer.py``) gets
the losses every ``LOG_EVERY`` train steps and each evaluator after its
pass; ``profile`` traces epoch 0 with ``torch.profiler``
(``utils/profiling.py``).

Data parallelism (``train_artiboost.py:189-225``, ``opt.py:26-44``):
``--multihost`` joins a process group (``parallel/mesh.py``; the coordinator
``host:port``, ``--num_processes`` and ``--process_id``, or torchrun's
environment), and ``--n_devices N`` in one process spawns N local ranks,
one a card. Each rank trains on its rows of every global batch; the
gradients, BatchNorm's statistics and every metric reduce over ranks, so
every rank holds the same parameters and CCV weight map. Rank 0 owns the
experiment directory, the summarizer and the trace; a ``--resume`` reads
the same checkpoint on every rank.

Usage:
    python -m artiboost_torch.train --cfg config/synthetic_smoke.yaml \\
        [--epochs N] [--batch_size B] [--device cuda|cpu] [--exp_id NAME] [--snapshot 50] \\
        [--test_freq 5] [--profile_dir DIR] [--profile_steps 20] [--workers 20] [--allow_dirty]
    python -m artiboost_torch.train --resume exp/<exp_id>_<timestamp> [--evaluate] [--device cpu]
    python -m artiboost_torch.train --cfg ... --n_devices 2 [--device cpu]
    python -m artiboost_torch.train --cfg ... --multihost --coordinator localhost:29500 \\
        --num_processes 2 --process_id {0,1}
    torchrun --nproc_per_node 4 -m artiboost_torch.train --cfg ... --multihost
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from artiboost_torch.artiboost.loader import ArtiBoostLoader, DrawSource
from artiboost_torch.criterions import build_criterion
from artiboost_torch.datasets.hodata import padded_host_loader
from artiboost_torch.datasets.synthetic import build_dataset
from artiboost_torch.metrics.evaluator import Evaluator, build_evaluator
from artiboost_torch.models.arch import build_arch
from artiboost_torch.parallel import mesh
from artiboost_torch.parallel.train_state import TrainStep, eval_step
from artiboost_torch.utils import profiling
from artiboost_torch.utils.batching import union_concat
from artiboost_torch.utils.config import load_config
from artiboost_torch.utils.etqdm import etqdm
from artiboost_torch.utils.misc import logger, resolve_device
from artiboost_torch.utils.pretrained import load_arch_pretrained
from artiboost_torch.utils.prefetch import IN_PLACE, HostPipeline
from artiboost_torch.utils.recorder import NullRecorder, Recorder
from artiboost_torch.utils.summarizer import NullSummarizer, Summarizer

LOG_EVERY = 20  # train steps between loss summaries (train_artiboost.py:92)


class StageTimer:
    """Host seconds per named stage. With ``sync`` (on a CUDA device) it
    synchronizes at each boundary, so device work is charged to the stage
    that queued it; without (the default, and what ``train.main`` runs) it
    never waits on the card and a stage's seconds are the host's time to
    queue its work. ``mark(wait=True)`` synchronizes whatever ``sync``
    says: an epoch's end, so that its seconds hold its device work."""

    def __init__(self, device: torch.device, sync: bool = False):
        self.cuda = device.type == "cuda"
        self.sync = sync and self.cuda
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    def mark(self, wait: bool = False):
        if self.sync or (wait and self.cuda):
            torch.cuda.synchronize()
        return time.perf_counter()

    def add(self, stage: str, t0: float) -> float:
        t1 = self.mark()
        self.seconds[stage] += t1 - t0
        self.calls[stage] += 1
        return t1


def slice_config(cfg: Dict) -> Dict:
    """The MANAGER node with DATA_PRESET and the val gates injected (the
    reference train_artiboost.py:166-167 injects them the same way)."""
    manager = dict(cfg.get("MANAGER", {}))
    manager.setdefault("DATA_PRESET", cfg["DATA_PRESET"])
    train = cfg.get("TRAIN", {})
    if "EVAL_FREQ" in train:
        manager.setdefault("VAL_FREQ", train["EVAL_FREQ"])
    if "VAL_START_EPOCH" in train:
        manager.setdefault("VAL_START_EPOCH", train["VAL_START_EPOCH"])
    return manager


def train_epoch(loader: ArtiBoostLoader, step: TrainStep, evaluator: Evaluator,
                timer: StageTimer, summarizer: Optional[Summarizer] = None,
                stop_trace_after: Optional[int] = None,
                host: Optional[HostPipeline] = None, pipeline: bool = True,
                epoch: int = 0) -> Dict:
    """One train epoch: -> {"steps", "images", "seconds" (host wall clock
    of the epoch, its device work included), "final_loss": [per-step
    device scalars], "real_host" (seconds of the real halves' geometry and
    decode, on the producer)}. The host halves of ``loader.iter_plan``'s
    real batches come from ``host.host_halves`` (made in place without a
    ``host``; the stage ``real wait`` is the time the step waited for one);
    their device half (upload, flip, warp) is the stage ``real batch``.

    With ``pipeline`` (``TRAIN.PIPELINE_SYNTH``, JAX
    ``train_artiboost.py:71-87``) the synth half of step N+1 is rendered
    before step N's device half and train step are queued, so the device
    queue holds render N+1 ahead of train N; step N's loss draws are taken
    before that render, so the generator gives S0, L0, S1, L1, ... in
    either order and both compute the same numbers. Nothing here waits on
    the card but the loss summary and the bar's postfix every
    ``LOG_EVERY`` steps and the epoch's end.

    Each step is a trace range ``train#<optimizer step>``; a running trace
    stops after step ``stop_trace_after``. Under a process group each step
    trains on this rank's rows (each rank renders its own rows of step
    N+1 ahead: no collective sits in a render); "images" counts the global
    batches', the evaluator and "final_loss" hold the global figures after
    the epoch, and the loss summary is the global batch's."""
    evaluator.reset_all()
    out = {"steps": 0, "images": 0, "final_loss": [], "real_host": [0.0, 0.0]}
    real_data = loader.real_dataset
    t = t_start = timer.mark()
    bar = etqdm((host or IN_PLACE).host_halves(real_data, loader.iter_plan(),
                                               loader._mixed_counts()[0]),
                total=len(loader), desc=f"TRAIN {epoch}")
    halves = iter(bar)

    def render(plan_sidx):
        sidx = loader.synth_indices(plan_sidx)
        return None if sidx is None else loader.synth_part(sidx)

    item = next(halves, None)
    t = timer.add("real wait", t)
    synth_next = None
    if pipeline and item is not None:
        synth_next = render(item[1])
        t = timer.add("synth batch", t)
    bidx = 0
    while item is not None:
        hb = item[0]
        with profiling.step_trace("train", step.step):
            if pipeline:
                synth = synth_next
                loss_draws = loader.draws.loss(step.criterion)
                item = next(halves, None)
                t = timer.add("real wait", t)
                synth_next = None if item is None else render(item[1])
            else:
                synth = render(item[1])
                loss_draws = loader.draws.loss(step.criterion)
            t = timer.add("synth batch", t)
            real = None
            if hb is not None:
                with profiling.trace("data/real_device"):
                    real = loader.real_part(hb)
                out["real_host"] = [a + b for a, b in zip(out["real_host"], hb.seconds)]
                t = timer.add("real batch", t)
            batch = union_concat([p for p in (real, synth) if p])
            with profiling.trace("artiboost/train_step"):
                preds, losses = step(batch, loss_draws)
                t = timer.add("train step", t)
            evaluator.feed_all(preds, batch, losses)
            if bidx % LOG_EVERY == 0:
                bar.set_postfix_str(str(evaluator))
                if summarizer is not None:
                    summarizer.summarize_losses(global_losses(losses), step.step,
                                                prefix="train")
            t = timer.add("metric+mining", t)
        if bidx == stop_trace_after and profiling.stop_trace():
            t = timer.mark()
        out["steps"] += 1
        out["images"] += int(batch["image"].shape[0]) * mesh.world()
        out["final_loss"].append(losses["final_loss"])
        bidx += 1
        if not pipeline:
            item = next(halves, None)
            t = timer.add("real wait", t)
    if mesh.world() > 1 and out["final_loss"]:
        out["final_loss"] = list(mesh.all_reduce_mean(torch.stack(out["final_loss"])))
    evaluator.all_reduce()
    out["seconds"] = timer.mark(wait=True) - t_start
    return out


def global_losses(losses: Dict) -> Dict:
    """The loss dict as the global batch's: under a process group each
    rank's values (its rows' sums over the global valid count) averaged
    over the ranks in one collective, as JAX's global-batch summary reads
    them; one process's dict as it is."""
    keys = [k for k, v in losses.items() if v is not None]
    if mesh.world() == 1 or not keys:
        return {k: losses[k] for k in keys}
    return dict(zip(keys, mesh.all_reduce_mean(torch.stack([losses[k].detach().float()
                                                            for k in keys]))))


def val_epoch(loader: ArtiBoostLoader, model: torch.nn.Module, criterion,
              evaluator: Evaluator, timer: StageTimer, epoch: int = 0) -> Dict:
    """The val sweep: pure-synth batches through the model with its running
    statistics, the evaluator refilled; not pipelined, as in JAX.
    -> {"batches", "images"}."""
    evaluator.reset_all()
    out = {"batches": 0, "images": 0}
    t = timer.mark()
    bar = etqdm(loader.iter_val(), total=loader.len_val(), desc=f"VAL {epoch}")
    for bidx, batch in enumerate(bar):
        t = timer.add("synth batch", t)
        preds, losses = eval_step(model, criterion, batch, loader.draws.loss(criterion))
        t = timer.add("forward", t)
        evaluator.feed_all(preds, batch, losses)
        if bidx % LOG_EVERY == 0:
            bar.set_postfix_str(str(evaluator))
        t = timer.add("metric+mining", t)
        out["batches"] += 1
        out["images"] += int(batch["image"].shape[0]) * mesh.world()
    evaluator.all_reduce()
    return out


def test_epoch(test_data, batch_size: int, model: torch.nn.Module, criterion,
               evaluator: Evaluator, draws: DrawSource, timer: StageTimer,
               host: Optional[HostPipeline] = None, epoch: int = 0) -> Dict:
    """The TEST pass (``train_artiboost.py:372-378``): every sample of the
    test split once, the tail batch repeat-padded and masked by
    SAMPLE_VALID (``padded_host_loader``, its host halves prefetched by
    ``host`` as the train pass's are), through the model with its running
    statistics; the evaluator refilled. Charged to the stage ``test pass``.
    Under a process group each rank runs its rows of every batch.
    -> {"batches", "images"}."""
    evaluator.reset_all()
    out = {"batches": 0, "images": len(test_data)}
    t = timer.mark()
    rows = mesh.rows(batch_size) if mesh.world() > 1 else None
    bar = etqdm(padded_host_loader(test_data, batch_size, host=host, rows=rows),
                total=-(-len(test_data) // batch_size), desc=f"TEST {epoch}")
    for batch in bar:
        preds, losses = eval_step(model, criterion, batch, draws.loss(criterion))
        n_valid = min(batch_size, len(test_data) - out["batches"] * batch_size)
        evaluator.feed_all(preds, batch, losses, n_global=n_valid)
        if out["batches"] % LOG_EVERY == 0:
            bar.set_postfix_str(str(evaluator))
        out["batches"] += 1
    evaluator.all_reduce()
    timer.add("test pass", t)
    return out


def _build_split(cfg: Dict, split: str, device, skipped: str):
    """DATASET.<split>, or None when the config has none or its real data
    is absent (``train_artiboost.py:242-254``)."""
    if split not in cfg.get("DATASET", {}):
        return None
    try:
        return build_dataset(cfg["DATASET"][split], cfg["DATA_PRESET"], device=device)
    except FileNotFoundError as e:
        logger.warning(f"{split.lower()} dataset unavailable ({e}); {skipped}")
        return None


def run(cfg: Dict, epochs: Optional[int] = None, device=None,
        model_state: Optional[Dict[str, torch.Tensor]] = None,
        draws: Optional[DrawSource] = None, timer: Optional[StageTimer] = None,
        recorder: Optional[Recorder] = None, resume: bool = False, snapshot: int = 50,
        summarizer: Optional[Summarizer] = None, test_freq: int = 5, evaluate: bool = False,
        profile: Optional[Tuple[str, int]] = None, workers: int = 20) -> Dict:
    """Train for ``epochs`` (default TRAIN.EPOCH). ``device`` None means
    CUDA (raises without one). ``model_state`` is the state dict of the
    ARCH's model, any of HybridBaseline, HOPRegNet, HoNet and
    SimpleBaseline (e.g. from ``utils.convert.FROM_FLAX[ARCH.TYPE]``);
    without it the weights are torch's initialisation under
    TRAIN.MANUAL_SEED. ``draws`` replaces
    the loader's random draws. ``recorder`` records the run and its
    checkpoints (``snapshot``: numbered every that many epochs);
    ``resume`` continues from the recorder's latest checkpoint.
    ``test_freq``: a TEST pass every that many epochs (0: none);
    ``evaluate``: one TEST pass, no training (raises without a TEST
    split). ``profile`` = (directory, steps): a trace from epoch 0's
    ``prepare()`` through its train step ``steps``. ``workers`` threads
    decode the real splits' images, whose host halves are made two batches
    ahead (``utils/prefetch.py``). Without ``model_state`` the ARCH's
    ``BACKBONE.PRETRAINED`` and ``PRETRAINED`` files load as the JAX entry
    point loads them (``utils/pretrained.py``). ``TRAIN.PIPELINE_SYNTH``
    (default true) renders each train step's synth half one step ahead
    (``train_epoch``). ``timer`` (default: one that never waits on the card)
    collects the per-stage host seconds. Returns the loader, the
    evaluators, model, train step, timer and the per-epoch counts."""
    if resume and recorder is None:
        raise ValueError("resume needs the recorder of the experiment to resume")
    device = resolve_device(device)
    data_preset = cfg["DATA_PRESET"]
    batch_size = int(cfg["TRAIN"]["BATCH_SIZE"])
    n_epochs = int(cfg["TRAIN"]["EPOCH"]) if epochs is None else int(epochs)
    seed = int(cfg["TRAIN"].get("MANUAL_SEED", 1))
    # PIPELINE_SYNTH (default on, JAX train_artiboost.py:321-326): render
    # each step's synth half one step ahead of its train step
    pipeline = bool(cfg["TRAIN"].get("PIPELINE_SYNTH", True))
    timer = timer or StageTimer(device)

    t = timer.mark()
    train_data = _build_split(cfg, "TRAIN", device, "synth-only training")
    test_data = _build_split(cfg, "TEST", device, "skipping test passes")
    t = timer.add("dataset init", t)
    metric_cfgs = cfg.get("EVALUATOR", [])
    evaluator = build_evaluator(metric_cfgs, data_preset, device=device)
    test_evaluator = build_evaluator([m for m in metric_cfgs
                                      if not m["TYPE"].startswith("ValMetric")],
                                     data_preset, device=device)
    criterion = build_criterion(cfg)
    loader = ArtiBoostLoader(train_data, cfg=slice_config(cfg), batch_size=batch_size,
                             n_epochs=n_epochs, seed=seed, device=device, draws=draws)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        arch = build_arch(cfg["ARCH"], data_preset)
    if model_state is not None:
        arch.model_list[0].load_state_dict(model_state)
    else:
        load_arch_pretrained(arch, cfg["ARCH"])
    if recorder is not None:
        recorder.record_arch(arch)
    step = TrainStep(arch, criterion, cfg["TRAIN"], device=device)

    t = timer.mark()
    loader.prepare()
    t = timer.add("pose sweep", t)
    epoch_start = 0
    if resume:
        epoch_start = recorder.resume_checkpoints(step)
        ab_state = recorder.resume_artiboost_state()
        if ab_state is not None:
            loader.load_state_dict(ab_state)
        logger.info(f"resumed from epoch {epoch_start}")
    host = HostPipeline(workers) if any(d is not None and d.images_on_host
                                        for d in (train_data, test_data)) else None
    try:
        out = {"loader": loader, "evaluator": evaluator, "test_evaluator": test_evaluator,
               "model": arch, "step": step, "timer": timer, "history": [],
               "train_data": train_data, "test_data": test_data}

        def test_pass(epoch: int) -> Dict:
            res = test_epoch(test_data, batch_size, arch, criterion, test_evaluator,
                             loader.draws, timer, host, epoch=epoch)
            res["measures"] = test_evaluator.get_measures_all_striped()
            if recorder is not None:
                recorder.record_evaluator(test_evaluator, epoch, "test")
            logger.info(f"test epoch {epoch}: {res['batches']} batches | {test_evaluator}")
            return res

        if evaluate:
            if test_data is None:
                raise RuntimeError("--evaluate requires a TEST dataset")
            out["history"].append({"epoch": epoch_start, "test": test_pass(epoch_start)})
            return out

        for epoch in range(epoch_start, n_epochs):
            traced = profile is not None and epoch == 0
            if traced:
                profiling.start_trace(profile[0])
            t = timer.mark()
            with profiling.trace("artiboost/prepare"):
                loader.prepare()
            timer.add("pose sweep", t)
            record = {"epoch": epoch, "train": train_epoch(
                loader, step, evaluator, timer, summarizer,
                stop_trace_after=profile[1] if traced else None, host=host,
                pipeline=pipeline, epoch=epoch)}
            profiling.stop_trace()  # a no-op unless a short epoch left the trace running
            record["train"]["measures"] = evaluator.get_measures_all_striped()
            if summarizer is not None:
                summarizer.summarize_evaluator(evaluator, epoch, "train")
            if recorder is not None:
                recorder.record_evaluator(evaluator, epoch, "train")
            if loader.should_val(epoch):
                t = timer.mark()
                with profiling.trace("artiboost/prepare_val"):
                    loader.prepare_val()
                timer.add("pose sweep", t)
                record["val"] = val_epoch(loader, arch, criterion, evaluator, timer, epoch)
                record["val"]["measures"] = evaluator.get_measures_all_striped()
                if summarizer is not None:
                    summarizer.summarize_evaluator(evaluator, epoch, "val")
                if recorder is not None:
                    recorder.record_evaluator(evaluator, epoch, "val")
            t = timer.mark()
            loader.step_eval(epoch, evaluator)
            timer.add("metric+mining", t)
            if recorder is not None:
                recorder.record_checkpoints(step, epoch, loader.state_dict(), snapshot=snapshot)
            record["train"]["final_loss"] = [float(v) for v in record["train"]["final_loss"]]
            logger.info(f"epoch {epoch}: {record['train']['steps']} train steps, "
                        f"{record.get('val', {}).get('batches', 0)} val batches | {evaluator}")
            if test_data is not None and test_freq > 0 and (epoch + 1) % test_freq == 0:
                record["test"] = test_pass(epoch)
                if summarizer is not None:
                    summarizer.summarize_evaluator(test_evaluator, epoch, "test")
            out["history"].append(record)
        return out

    finally:
        if host is not None:
            host.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv, n_ranks: int, port: int):
    """One of ``--n_devices``'s spawned ranks."""
    main(list(argv) + ["--multihost", "--coordinator", f"localhost:{port}",
                       "--num_processes", str(n_ranks), "--process_id", str(rank)])


def main(argv=None) -> Dict:
    """The command line (``artiboost_tpu/opt.py``'s flags that the port
    runs) -> ``run``'s result, with the experiment's ``dump_path`` (None on
    a rank other than 0). ``--n_devices N`` spawns N ranks and returns
    {"ranks": N} once all have finished."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None, help="overrides TRAIN.BATCH_SIZE")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--exp_id", default="default")
    ap.add_argument("--resume", default=None,
                    help="experiment directory to resume; its dump_cfg.yaml is the config")
    ap.add_argument("--evaluate", action="store_true",
                    help="run one TEST pass (of the resumed model) instead of training")
    ap.add_argument("--snapshot", type=int, default=50,
                    help="keep a numbered checkpoint every this many epochs")
    ap.add_argument("--test_freq", type=int, default=5,
                    help="a TEST pass every this many epochs (0: none)")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler Chrome trace of epoch 0 here")
    ap.add_argument("--profile_steps", type=int, default=20,
                    help="the trace ends after this train step of epoch 0")
    ap.add_argument("--workers", type=int, default=20,
                    help="host data worker threads (image decode)")
    ap.add_argument("--allow_dirty", action="store_true",
                    help="record a named experiment from an uncommitted tree")
    ap.add_argument("--multihost", action="store_true",
                    help="join a data-parallel process group (torch.distributed)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous (omit under torchrun)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--n_devices", type=int, default=None,
                    help="spawn this many local ranks, one a card (without --multihost)")
    ap.add_argument("--gpu_id", default=None,
                    help="compatibility no-op (the rank picks its card)")
    args = ap.parse_args(argv)
    if not (args.cfg or args.resume):
        ap.error("--cfg is required unless --resume is given")
    device = resolve_device(args.device)
    if args.n_devices and args.n_devices > 1 and not args.multihost:
        import sys

        import torch.multiprocessing as mp

        mp.spawn(_rank_main, args=(sys.argv[1:] if argv is None else argv, args.n_devices,
                                   _free_port()), nprocs=args.n_devices, join=True)
        return {"ranks": args.n_devices}
    joined = args.multihost and mesh.init_distributed(
        args.coordinator, args.num_processes, args.process_id, device_type=device.type)
    try:
        return _train_main(args, mesh.rank_device(device))
    finally:
        if joined:
            mesh.close()


def _train_main(args, device: torch.device) -> Dict:
    if args.resume:
        if args.cfg:
            logger.warning(f"--cfg is replaced by {args.resume}/dump_cfg.yaml on --resume")
        cfg = load_config(os.path.join(args.resume, "dump_cfg.yaml"))
    else:
        cfg = load_config(args.cfg)
    if args.batch_size:
        cfg.setdefault("TRAIN", {})["BATCH_SIZE"] = args.batch_size
    if mesh.rank() == 0:
        recorder = Recorder(args.exp_id, cfg, resume_path=args.resume,
                            allow_dirty=args.allow_dirty)
        summarizer = Summarizer(recorder.dump_path)
        profile = (args.profile_dir, args.profile_steps) if args.profile_dir else None
    else:
        recorder, summarizer, profile = NullRecorder(args.resume), NullSummarizer(), None
    try:
        out = run(cfg, epochs=args.epochs, device=device, recorder=recorder,
                  resume=bool(args.resume), snapshot=args.snapshot, summarizer=summarizer,
                  test_freq=args.test_freq, evaluate=args.evaluate, profile=profile,
                  workers=args.workers)
    finally:
        summarizer.close()
        recorder.close()
    out["dump_path"] = recorder.dump_path
    losses = [v for r in out["history"] for v in r.get("train", {}).get("final_loss", [])]
    if losses:
        w = out["loader"].ccv.sample_weight_map
        logger.info(f"done: {len(losses)} train steps, final_loss {losses[0]:.5f} -> "
                    f"{losses[-1]:.5f}; weight map [{float(w.min()):.3f}, {float(w.max()):.3f}]")
    return out


if __name__ == "__main__":
    main()
