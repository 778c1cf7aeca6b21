"""Tracing (counterpart of ``artiboost_tpu/utils/profiling.py``): named
spans with counters, and one ``torch.profiler`` session over CPU and CUDA
activity that writes a Chrome trace (``chrome://tracing``, Perfetto) into
its directory when it stops, the spans merged into it. Usage::

    python -m artiboost_torch.train ... --profile_dir exp/trace --profile_steps 20

or programmatically::

    with trace("engine/sweep", triplets=n):
        ...
    with trace("recorder/checkpoint") as span:
        n = write()
        span.count(bytes=n)

A span is a named interval on the thread that opens it, on any thread.
While no session runs, ``trace`` returns one shared null context: no
clock is read, nothing is recorded and no ``record_function`` is entered,
so a span costs a function call. While a session runs, each span keeps
the thread's native id, its start and end (``time.time_ns``: the clock
whose ``baseTimeNanoseconds`` offset the profiler's own export gives its
events, the device's among them), its id, the id of the span it opened
in on the same thread (``parent``), the optimizer step of the enclosing
``train#<step>`` (``step``: every span of one step shares it) and its
counts. ``stop_trace`` writes them into the exported trace as
``user_annotation`` events on their thread's row, ``args`` holding
``id``, ``parent``, ``step`` and the counts.

Counts come from shapes and host integers only: a span never reads a
device value, so it never waits on the card.

A process holds one profiler session at a time, as it does in
``torch.profiler`` itself, so the session is module state."""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time
from typing import List, Optional

import torch

from artiboost_torch.utils.misc import logger


class _Session:
    def __init__(self, prof, log_dir: str):
        self.prof, self.log_dir = prof, log_dir
        # (name, thread id, start ns, end ns, id, parent id, step, counts)
        self.spans: List[tuple] = []


class _NullSpan:
    """What ``trace`` returns while no session runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_NULL = _NullSpan()
_session: Optional[_Session] = None
_ids = itertools.count(1)
_local = threading.local()  # .open: the innermost open span of this thread


class _Span:
    __slots__ = ("session", "name", "counts", "step", "id", "parent", "prev", "t0")

    def __init__(self, session: _Session, name: str, counts: dict, step: Optional[int]):
        self.session, self.name, self.counts, self.step = session, name, counts, step

    def __enter__(self):
        self.prev = prev = getattr(_local, "open", None)
        self.id = next(_ids)
        self.parent = None if prev is None else prev.id
        if self.step is None and prev is not None:
            self.step = prev.step
        _local.open = self
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.open = self.prev
        self.session.spans.append((self.name, threading.get_native_id(), self.t0, t1, self.id,
                                   self.parent, self.step, self.counts))
        return False

    def count(self, **counts) -> None:
        """Counts known only once the span's work is done."""
        self.counts.update(counts)


def trace(name: str, **counts):
    """A span named ``name`` with integer ``counts`` (from shapes and host
    values), recorded while a session runs; one shared null context else."""
    session = _session
    if session is None:
        return _NULL
    return _Span(session, name, counts, None)


def step_trace(name: str, step: int):
    """One train or eval step as a span named ``<name>#<step>``; every span
    inside it carries ``step``."""
    session = _session
    if session is None:
        return _NULL
    return _Span(session, f"{name}#{step}", {}, int(step))


def _merge_spans(path: str, spans: List[tuple]) -> None:
    """Write the spans into the Chrome trace at ``path`` (its timestamps
    are microseconds after ``baseTimeNanoseconds``): spliced in before the
    end of its ``traceEvents`` list, which the profiler writes ahead of its
    closing ``traceName``, so that a trace of hundreds of megabytes is not
    parsed and written again."""
    if not spans:
        return
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        f.seek(max(f.seek(0, os.SEEK_END) - (1 << 16), 0))
        tail_at = f.tell()
        tail = f.read()
    base = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    ends = list(re.finditer(rb'\]\s*,\s*"traceName"\s*:', tail))
    if base is None or not ends:
        raise ValueError(f"{path}: no 'baseTimeNanoseconds' in its header or no "
                         "'], \"traceName\"' at its end; the spans cannot be merged")
    at = ends[-1].start()
    body = ", ".join(json.dumps(e) for e in _span_events(spans, int(base.group(1))))
    empty = tail[:at].rstrip().endswith(b"[")
    with open(path, "r+b") as f:
        f.seek(tail_at + at)
        f.write((body if empty else ", " + body).encode() + tail[at:])


def _span_events(spans: List[tuple], base: int) -> List[dict]:
    pid = os.getpid()
    return [{"ph": "X", "cat": "user_annotation", "name": name, "pid": pid, "tid": tid,
             "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
             "args": {"id": sid, "parent": parent, "step": step, **counts}}
            for name, tid, t0, t1, sid, parent, step, counts in spans]


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
        _session = _Session(prof, log_dir)


def stop_trace() -> Optional[str]:
    """Stop the running trace and write it, its spans merged in, as
    ``<log_dir>/trace_<timestamp>_<pid>.json`` -> that path (None when no
    trace ran)."""
    global _session
    if _session is None:
        return None
    session, _session = _session, None
    session.prof.stop()
    os.makedirs(session.log_dir, exist_ok=True)
    path = os.path.join(session.log_dir,
                        f"trace_{time.strftime('%Y_%m%d_%H%M_%S')}_{os.getpid()}.json")
    session.prof.export_chrome_trace(path)
    _merge_spans(path, session.spans)
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
