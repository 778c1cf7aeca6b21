"""The command line of both entry points (counterpart of
``artiboost_tpu/opt.py``'s ``build_parser`` and ``parse_extra_args``).

Every flag of the JAX package's two parsers is here under its name, type,
``nargs``, choices and default, with the port's own ``--device`` and
``--epochs``; ``train.main`` and ``submit_reload.main`` add their own and
parse strictly, so a misspelt flag raises where JAX's ``parse_known_args``
would drop it. Both JAX entry points share one parser, so each accepts the
other's flags: a flag that the entry point does not read is logged once as
having no effect (``log_unread``)."""
from __future__ import annotations

import argparse
from typing import Iterable

from artiboost_torch.utils.misc import logger

# flags no code of the JAX package reads (``main_worker(arg, cfg, extra)``
# never touches ``extra``, train_artiboost.py:224), kept so that its
# command lines run; ``--opg_batch_size`` stays one of them: the pose
# sweep's chunk is the config's MANAGER.OPG_BATCH_SIZE
NO_EFFECT = ("vis_toc", "gpu_id", "resume_epoch", "true_root", "true_bone_scale",
             "use_pseudo_hand_root", "opg_batch_size", "opg_num_workers", "gpu_render_id",
             "synth_root")
# read by training only
TRAIN_ONLY = ("epochs", "allow_dirty", "evaluate", "snapshot", "test_freq", "profile_dir",
              "profile_steps")
# read by the submission only (``--filter_unseen_obj_idxs`` reaches the
# metrics through ``build_evaluator(ARG=...)`` there; training passes no
# ARG, train_artiboost.py:269)
SUBMIT_ONLY = ("submit_dataset", "filter_unseen_obj_idxs", "submit_dump",
               "postprocess_fit_mesh", "postprocess_fit_mesh_ik",
               "postprocess_fit_mesh_use_fitted_joints", "postprocess_draw",
               "postprocess_draw_path")


def build_parser(description: str = "ArtiBoost on PyTorch") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--vis_toc", type=float, default=5)
    # experiment
    ap.add_argument("--cfg", type=str, default=None, help="experiment config file")
    ap.add_argument("--exp_id", type=str, default="default")
    ap.add_argument("--resume", type=str, default=None,
                    help="experiment directory to resume (train) or whose "
                         "checkpoints/latest.pt to evaluate (submission)")
    ap.add_argument("--allow_dirty", action="store_true",
                    help="record a named experiment from an uncommitted tree")
    ap.add_argument("--multihost", action="store_true",
                    help="join a data-parallel process group (torch.distributed)")
    ap.add_argument("--coordinator", type=str, default=None,
                    help="host:port of rank 0's rendezvous (omit under torchrun)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--workers", type=int, default=20,
                    help="host data worker threads (image decode)")
    ap.add_argument("--batch_size", type=int, default=None, help="overrides TRAIN.BATCH_SIZE")
    ap.add_argument("--evaluate", action="store_true",
                    help="run one TEST pass (of the resumed model) instead of training")
    # general
    ap.add_argument("--gpu_id", type=str, default=None,
                    help="no effect (each rank picks its card)")
    ap.add_argument("--snapshot", type=int, default=50,
                    help="keep a numbered checkpoint every this many epochs")
    ap.add_argument("--test_freq", type=int, default=5,
                    help="a TEST pass every this many epochs (0: none)")
    ap.add_argument("--n_devices", type=int, default=None,
                    help="spawn this many local ranks, one a card (without --multihost)")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of epoch 0 here")
    ap.add_argument("--profile_steps", type=int, default=20,
                    help="the trace ends after this train step of epoch 0")
    # submit
    ap.add_argument("--resume_epoch", type=int, default=0)
    ap.add_argument("--submit_dataset", type=str, default="hodata")
    ap.add_argument("--filter_unseen_obj_idxs", type=int, nargs="+", default=[],
                    help="object ids whose corner EPEs the submission drops")
    ap.add_argument("--true_root", action="store_true")
    ap.add_argument("--true_bone_scale", action="store_true")
    ap.add_argument("--submit_dump", action="store_true")
    ap.add_argument("--postprocess_fit_mesh", action="store_true")
    ap.add_argument("--postprocess_fit_mesh_ik", type=str, choices=["iknet", "iksolver"],
                    default="iknet")
    ap.add_argument("--postprocess_fit_mesh_use_fitted_joints", action="store_true")
    ap.add_argument("--use_pseudo_hand_root", action="store_true")
    ap.add_argument("--postprocess_draw", action="store_true")
    ap.add_argument("--postprocess_draw_path", type=str, default=None)
    # ArtiBoost generation (``parse_extra_args``)
    ap.add_argument("--opg_batch_size", type=int, default=256)
    ap.add_argument("--opg_num_workers", type=int, default=20)
    ap.add_argument("--gpu_render_id", type=str, default=None)
    ap.add_argument("--synth_root", type=str, default=None)
    # the port's own
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=None, help="overrides TRAIN.EPOCH")
    return ap


def log_unread(args: argparse.Namespace, ap: argparse.ArgumentParser,
               unread: Iterable[str]) -> None:
    """One line for each flag of ``unread`` given other than its default,
    from the first process of a run only (a spawned rank parses again)."""
    if getattr(args, "process_id", None):
        return
    for name in unread:
        if getattr(args, name) != ap.get_default(name):
            logger.info(f"--{name} accepted for the JAX command line; no effect")
