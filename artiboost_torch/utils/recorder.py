"""Recorder: experiment directory, config dump, checkpoint and resume
(counterpart of ``artiboost_tpu/utils/recorder.py``; reference
``anakin/utils/recorder.py``).

Layout, as the JAX package writes it: ``<root>/<exp_id>_<timestamp>/``
holds ``checkpoints/``, ``evaluations/``, ``log.txt`` and
``dump_cfg.yaml``. A checkpoint is one ``torch.save`` file (``latest.pt``
every epoch, ``epoch_<n>.pt`` every ``snapshot`` epochs) in place of the
JAX package's orbax directories ``latest`` and ``epoch_<n>``. The
ArtiBoost state goes to ``artiboost_latest.npz`` (and
``artiboost_epoch_<n>.npz``) with the JAX package's keys
(``sample_weight_map``, ``occurrence_map``, ``epoch_idx``); the JAX
loader's threefry key ``rng_key`` has no counterpart, and the loader's
torch generator state ``rng_state`` stands in its place. A
``synth_shutdown`` marker file records that synthesis was shut down."""
from __future__ import annotations

import json
import math
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from artiboost_torch.metrics.vismetric import VisMetric
from artiboost_torch.utils.logger import add_file_handler
from artiboost_torch.utils.misc import logger


def _git(*args: str) -> Optional[str]:
    """stdout of ``git <args>``, or None outside a repository or without git."""
    try:
        out = subprocess.run(["git", *args], capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _git_commit() -> Optional[str]:
    """The current HEAD, or None."""
    return _git("rev-parse", "HEAD") or None


def _git_dirty() -> bool:
    """True when the working tree has uncommitted changes."""
    return bool(_git("status", "--porcelain"))


def dump_config(cfg: Dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def _draw_arch_png(names: List[str], edges: List[Tuple[str, str]], path: str) -> None:
    """The model DAG as a PNG drawn with Pillow: nodes layered by their
    longest path from a source, boxes and arrows."""
    from PIL import Image, ImageDraw

    preds: Dict[str, list] = {n: [] for n in names}
    for a, b in edges:
        preds[b].append(a)
    depth: Dict[str, int] = {}

    def _depth(n, seen=()):
        if n not in depth:
            # a cycle is drawn flat rather than recursed forever
            depth[n] = 0 if not preds[n] or n in seen else \
                1 + max(_depth(p, seen + (n,)) for p in preds[n])
        return depth[n]

    layers: Dict[int, list] = {}
    for n in names:
        layers.setdefault(_depth(n), []).append(n)
    n_layers, n_wide = max(layers) + 1, max(len(v) for v in layers.values())
    bw, bh, gx, gy, margin = 180, 44, 60, 70, 30
    width = margin * 2 + n_wide * bw + (n_wide - 1) * gx
    height = margin * 2 + n_layers * bh + (n_layers - 1) * gy
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    pos: Dict[str, tuple] = {}
    for d in range(n_layers):
        row = sorted(layers.get(d, []))
        x0 = (width - (len(row) * bw + (len(row) - 1) * gx)) // 2
        y = margin + d * (bh + gy)
        for i, n in enumerate(row):
            x = x0 + i * (bw + gx)
            pos[n] = (x + bw // 2, y, y + bh)
            draw.rectangle([x, y, x + bw, y + bh], outline="black", fill=(235, 240, 250), width=2)
            draw.text((x + 8, y + bh // 2 - 6), n if len(n) <= 24 else n[:23] + "…", fill="black")
    for a, b in edges:
        ax, _, ay1 = pos[a]
        bx, by0, _ = pos[b]
        draw.line([ax, ay1, bx, by0], fill="black", width=2)
        ang = math.atan2(by0 - ay1, bx - ax)
        for s in (-0.4, 0.4):
            draw.line([bx, by0, bx - 10 * math.cos(ang + s), by0 - 10 * math.sin(ang + s)],
                      fill="black", width=2)
    img.save(path)


def _save_npz(path: str, state: Dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in state.items() if not isinstance(v, bool)})


class Recorder:
    def __init__(self, exp_id: str, cfg: Dict, root: str = "exp",
                 resume_path: Optional[str] = None, timestamp: Optional[str] = None,
                 allow_dirty: bool = False, eval_only: bool = False):
        """A named experiment (any ``exp_id`` but ``default`` and
        ``smoke``) must run from a clean commit unless ``allow_dirty``;
        without a commit it warns. ``resume_path`` reuses an experiment
        directory and keeps its ``dump_cfg.yaml``. ``eval_only`` records an
        evaluation: ``<root>/eval_<exp_id>_<timestamp>/`` with no
        ``checkpoints/`` and no commit check."""
        self.exp_id, self.cfg = exp_id, cfg
        if not eval_only and exp_id not in ("default", "smoke"):
            commit = _git_commit()
            if commit is None:
                logger.warning(f"exp '{exp_id}' started without a git commit: the run "
                               "will not be reproducible from version control")
            elif _git_dirty():
                if not allow_dirty:
                    raise RuntimeError(
                        f"exp '{exp_id}' @ git {commit[:12]} has UNCOMMITTED changes; named "
                        "experiments must be reproducible from a commit. Commit first, or "
                        "pass --allow_dirty to record the dirty run anyway.")
                logger.warning(f"exp '{exp_id}' @ git {commit[:12]} with UNCOMMITTED changes "
                               "(--allow_dirty): NOT reproducible from version control")
            else:
                logger.info(f"exp '{exp_id}' @ git {commit[:12]}")
        ts = timestamp or time.strftime("%Y_%m%d_%H%M_%S")
        prefix = "eval_" if eval_only else ""
        self.dump_path = resume_path or os.path.join(root, f"{prefix}{exp_id}_{ts}")
        self.ckpt_dir = os.path.abspath(os.path.join(self.dump_path, "checkpoints"))
        self.eval_dir = os.path.join(self.dump_path, "evaluations")
        if not eval_only:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.eval_dir, exist_ok=True)
        self._log = add_file_handler(os.path.join(self.dump_path, "log.txt"))
        if not resume_path:
            dump_config(cfg, os.path.join(self.dump_path, "dump_cfg.yaml"))

    def close(self) -> None:
        """Detach and close ``log.txt``."""
        logger.removeHandler(self._log)
        self._log.close()

    # ---- checkpoints ----
    def record_checkpoints(self, step, epoch: int, artiboost_state: Optional[Dict] = None,
                           snapshot: int = 10) -> None:
        """``latest.pt`` every epoch and ``epoch_<n>.pt`` every ``snapshot``
        epochs. ``step`` is the ``TrainStep``: its model, optimizer and
        schedule position are stored with torch's CPU (and CUDA) RNG
        states. The stored epoch is the number of COMPLETED epochs, so a
        resumed run continues with ``range(epoch, n_epochs)``."""
        payload = {"epoch": epoch + 1, "model": step.model.state_dict(),
                   "optimizer": step.optimizer.state_dict(), "scheduler": {"step": step.step},
                   "rng_cpu": torch.get_rng_state()}
        if torch.cuda.is_available():
            payload["rng_cuda"] = torch.cuda.get_rng_state_all()
        self._save(os.path.join(self.ckpt_dir, "latest.pt"), payload)
        if artiboost_state is not None:
            _save_npz(os.path.join(self.ckpt_dir, "artiboost_latest.npz"), artiboost_state)
            if not artiboost_state.get("use_synth", True):
                open(os.path.join(self.ckpt_dir, "synth_shutdown"), "w").close()
        if snapshot and (epoch + 1) % snapshot == 0:
            self._save(os.path.join(self.ckpt_dir, f"epoch_{epoch + 1}.pt"), payload)
            if artiboost_state is not None:
                _save_npz(os.path.join(self.ckpt_dir, f"artiboost_epoch_{epoch + 1}.npz"),
                          artiboost_state)

    @staticmethod
    def _save(path: str, payload: Dict) -> None:
        """Write beside the target, then rename: a run killed mid-write
        leaves the previous checkpoint intact."""
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def resume_checkpoints(self, step, path: Optional[str] = None) -> int:
        """Load a checkpoint (default ``latest.pt``) into ``step``'s model,
        optimizer and schedule and restore torch's RNG states -> the
        number of completed epochs."""
        path = os.path.abspath(path or os.path.join(self.ckpt_dir, "latest.pt"))
        # loaded to the host: load_state_dict copies each tensor to its
        # parameter's device, and Adam's step counts stay on the host as in
        # an uninterrupted run
        payload = torch.load(path, map_location="cpu", weights_only=True)
        step.model.load_state_dict(payload["model"])
        step.optimizer.load_state_dict(payload["optimizer"])
        step.step = int(payload["scheduler"]["step"])
        torch.set_rng_state(payload["rng_cpu"])
        if "rng_cuda" in payload and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(payload["rng_cuda"])
        return int(payload["epoch"])

    def resume_artiboost_state(self) -> Optional[Dict]:
        path = os.path.join(self.ckpt_dir, "artiboost_latest.npz")
        if not os.path.isfile(path):
            return None
        with np.load(path) as blob:
            state = {k: blob[k] for k in blob.files}
        state["use_synth"] = not os.path.isfile(os.path.join(self.ckpt_dir, "synth_shutdown"))
        return state

    # ---- dumps ----
    def record_arch(self, arch) -> None:
        """The model DAG as text, DOT and PNG (``arch.txt``, ``.dot``, ``.png``)."""
        path = os.path.join(self.dump_path, "arch")
        edges = [(arch.names[p], arch.names[i])
                 for i, prevs in enumerate(arch.previous) for p in prevs]
        with open(path + ".txt", "w") as f:
            f.write("nodes: " + ", ".join(arch.names) + "\n")
            f.writelines(f"{a} -> {b}\n" for a, b in edges)
        with open(path + ".dot", "w") as f:
            f.write("digraph arch {\n")
            f.writelines(f'  "{n}";\n' for n in arch.names)
            f.writelines(f'  "{a}" -> "{b}";\n' for a, b in edges)
            f.write("}\n")
        _draw_arch_png(list(arch.names), edges, path + ".png")

    def record_evaluator(self, evaluator, epoch: int, split: str = "train") -> Dict:
        """The evaluator's scalar measures (``get_measures_all_striped``) as
        ``<split>_epoch_<n>.json``, its summary line as ``.txt`` and each
        visualisation metric's image as ``<split>_epoch_<n>_<Metric>.png``
        under ``evaluations/``."""
        measures = evaluator.get_measures_all_striped()
        path = os.path.join(self.eval_dir, f"{split}_epoch_{epoch}")
        with open(path + ".json", "w") as f:
            json.dump(measures, f, indent=2, default=float)
        with open(path + ".txt", "w") as f:
            f.write(str(evaluator) + "\n")
        for metric in evaluator.metrics_list:
            if isinstance(metric, VisMetric) and metric.images is not None:
                metric.images.save(path + f"_{type(metric).__name__}.png")
        return measures


class NullRecorder:
    """The recorder of a rank other than 0 in a data-parallel run: rank 0
    owns the experiment directory, its evaluations and checkpoints
    (``train_artiboost.py:189-221``). A resume reads the experiment's
    checkpoint on every rank, the same file rank 0 reads, where the JAX
    package raises on the other ranks (:205-207)."""

    dump_path = None

    def __init__(self, resume_path: Optional[str] = None):
        self.ckpt_dir = (os.path.abspath(os.path.join(resume_path, "checkpoints"))
                         if resume_path else None)

    resume_checkpoints = Recorder.resume_checkpoints
    resume_artiboost_state = Recorder.resume_artiboost_state

    def record_arch(self, *a, **k):
        pass

    def record_evaluator(self, *a, **k):
        pass

    def record_checkpoints(self, *a, **k):
        pass

    def close(self):
        pass
