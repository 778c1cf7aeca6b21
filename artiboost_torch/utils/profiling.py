"""Tracing hooks (counterpart of ``artiboost_tpu/utils/profiling.py``):
named host ranges, and one ``torch.profiler`` session over CPU and CUDA
activity that writes a Chrome trace (``chrome://tracing``, Perfetto) into
its directory when it stops. Usage::

    python -m artiboost_torch.train ... --profile_dir exp/trace --profile_steps 20

or programmatically::

    with trace("artiboost/prepare"):
        loader.prepare()

A process holds one profiler session at a time, as it does in
``torch.profiler`` itself, so the session is module state. The profiler's
callbacks are thread-local and see only the thread that started it: a
range on another thread (the data pipeline's producer) is a
``thread_trace``, kept by this module and merged into the exported trace
on that thread's row."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, Optional

import torch

from artiboost_torch.utils.misc import logger

# (profiler, trace directory, [(name, thread id, start ns, end ns) of
# thread_trace]) while tracing
_session: Optional[tuple] = None


def trace(name: str):
    """A named host range; shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def step_trace(name: str, step: int):
    """One train or eval step as a range named ``<name>#<step>``."""
    return torch.profiler.record_function(f"{name}#{step}")


@contextlib.contextmanager
def thread_trace(name: str):
    """A named range on any thread, kept while a trace runs and written
    into it (``stop_trace``)."""
    session = _session
    if session is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        session[2].append((name, threading.get_native_id(), t0, time.time_ns()))


def _merge_thread_spans(path: str, spans: List[tuple]) -> None:
    """Append ``thread_trace`` ranges to the Chrome trace at ``path`` (its
    timestamps are microseconds after ``baseTimeNanoseconds``)."""
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc["traceEvents"] += [{"ph": "X", "cat": "user_annotation", "name": name, "pid": pid,
                            "tid": tid, "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3}
                           for name, tid, t0, t1 in spans]
    with open(path, "w") as f:
        json.dump(doc, f)


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
        _session = (prof, log_dir, [])


def stop_trace() -> Optional[str]:
    """Stop the running trace and write it as
    ``<log_dir>/trace_<timestamp>_<pid>.json`` -> that path (None when no
    trace ran)."""
    global _session
    if _session is None:
        return None
    prof, log_dir, spans = _session
    _session = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y_%m%d_%H%M_%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    _merge_thread_spans(path, spans)
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
