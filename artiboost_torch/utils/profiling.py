"""Tracing hooks (counterpart of ``artiboost_tpu/utils/profiling.py``):
named host ranges, and one ``torch.profiler`` session over CPU and CUDA
activity that writes a Chrome trace (``chrome://tracing``, Perfetto) into
its directory when it stops. Usage::

    python -m artiboost_torch.train ... --profile_dir exp/trace --profile_steps 20

or programmatically::

    with trace("artiboost/prepare"):
        loader.prepare()

A process holds one profiler session at a time, as it does in
``torch.profiler`` itself, so the session is module state."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from artiboost_torch.utils.misc import logger

_session: Optional[tuple] = None  # (profiler, trace directory) while tracing


def trace(name: str):
    """A named host range; shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def step_trace(name: str, step: int):
    """One train or eval step as a range named ``<name>#<step>``."""
    return torch.profiler.record_function(f"{name}#{step}")


def start_trace(log_dir: str) -> None:
    """Start tracing CPU activity, and CUDA activity where there is a card;
    a no-op while a trace runs."""
    global _session
    if _session is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _session = (prof, log_dir)


def stop_trace() -> Optional[str]:
    """Stop the running trace and write it as
    ``<log_dir>/trace_<timestamp>_<pid>.json`` -> that path (None when no
    trace ran)."""
    global _session
    if _session is None:
        return None
    prof, log_dir = _session
    _session = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y_%m%d_%H%M_%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"trace written to {path}")
    return path


@contextlib.contextmanager
def trace_window(log_dir: Optional[str]):
    """Trace everything inside the block when ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
