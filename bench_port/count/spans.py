"""The program's spans in a ``torch.profiler`` Chrome trace, and what the
card did under each: each device event (kernel, copy, set) is tied to the
runtime call that launched it by Kineto's ``correlation`` argument, and
each runtime call to the innermost program span open on its thread when
it started; a call on a thread with no program span open then (torch's
autograd thread, which runs the backward pass of a CUDA graph while the
main thread waits in ``backward()``) to the innermost one open on the main
thread. Program spans are the ``user_annotation`` events that
``artiboost_torch/utils/profiling.py`` writes, with ``id`` and ``parent``
in their ``args``; a trace without them (a program that has no such
spans) gives no span, and the readers built on this return None."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set

from bench_port.count.trace import DEVICE_CATS

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime and driver calls that return only once the card has caught up
BLOCKING = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"}


def is_launch(name: str) -> bool:
    """A kernel launch call (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
    ``cuLaunchKernel``, ``cudaGraphLaunch``, ...)."""
    return "Launch" in name


class SpanIndex:
    """The spans of a trace inside the window [lo, hi] (us), and every
    runtime call with the span it ran in (``main_tid``: the main thread)."""

    def __init__(self, events: List[Dict], lo: float, hi: float, main_tid=None):
        self.lo, self.hi, self.main_tid = lo, hi, main_tid
        self.spans: Dict[int, Dict] = {}
        for e in events:
            args = e.get("args") or {}
            if e.get("cat") == "user_annotation" and "id" in args and "parent" in args:
                self.spans[args["id"]] = e
        by_tid = defaultdict(list)
        for sid, e in self.spans.items():
            by_tid[e["tid"]].append((e["ts"], sid))
        self._starts = {tid: sorted(v) for tid, v in by_tid.items()}
        self.device = defaultdict(list)  # correlation -> device events
        self.runtime: List[Dict] = []
        for e in events:
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device[(e.get("args") or {}).get("correlation")].append(e)
            elif cat in RUNTIME_CATS:
                self.runtime.append(e)
        self.launched_in = [(e, self.launching_span(e)) for e in self.runtime]

    def launching_span(self, call: Dict) -> Optional[int]:
        sid = self.innermost(call["tid"], call["ts"])
        if sid is None and call["tid"] != self.main_tid:
            sid = self.innermost(self.main_tid, call["ts"])
        return sid

    def innermost(self, tid, ts: float) -> Optional[int]:
        """The id of the innermost span open on thread ``tid`` at ``ts``. The
        spans of a thread nest, so it is the last one to start at or before
        ``ts``, or the nearest of its ancestors still open then."""
        starts = self._starts.get(tid)
        if not starts:
            return None
        k = bisect.bisect_right(starts, (ts, float("inf"))) - 1
        sid = starts[k][1] if k >= 0 else None
        while sid is not None:
            e = self.spans.get(sid)
            if e is None:
                return None
            if e["ts"] + e["dur"] >= ts:
                return sid
            sid = e["args"]["parent"]
        return None

    def named(self, names: Iterable[str]) -> List[Dict]:
        """The spans of these names that start inside the window."""
        names = set(names)
        return [e for e in self.spans.values()
                if e["name"] in names and self.lo <= e["ts"] < self.hi]

    def under(self, names: Iterable[str]) -> Set[int]:
        """The ids of the window's spans of these names and of every span
        inside them."""
        top = {e["args"]["id"] for e in self.named(names)}
        out = set()
        for sid in self.spans:
            s = sid
            while s is not None and s not in top and s in self.spans:
                s = self.spans[s]["args"]["parent"]
            if s in top:
                out.add(sid)
        return out

    def device_us(self, names: Iterable[str]) -> float:
        """Microseconds of the device events launched under the spans."""
        ids = self.under(names)
        return sum(d["dur"] for e, sid in self.launched_in if sid in ids
                   for d in self.device.get((e.get("args") or {}).get("correlation"), ()))

    def launches(self, names: Iterable[str]) -> int:
        """Kernel launch calls made under the spans."""
        ids = self.under(names)
        return sum(1 for e, sid in self.launched_in if sid in ids and is_launch(e["name"]))

    def blocked_us(self, tid, names: Iterable[str]) -> float:
        """Microseconds the thread spent, under the spans, in runtime calls
        that block on the card: the synchronizes, and the copies from the
        device to the host that wait for it (into pageable memory, or by the
        synchronous ``cudaMemcpy``). A copy into pinned memory returns at
        once; the synchronize that waits for it counts."""
        ids = self.under(names)
        total = 0.0
        for e, sid in self.launched_in:
            if e["tid"] != tid or sid not in ids:
                continue
            name = e["name"]
            dev = self.device.get((e.get("args") or {}).get("correlation"), ())
            if name in BLOCKING or ("Memcpy" in name and any(
                    "DtoH" in d["name"] and ("Pageable" in d["name"] or "Async" not in name)
                    for d in dev)):
                total += e["dur"]
        return total


def index(ctx: Dict) -> SpanIndex:
    """The traced unit's ``SpanIndex``, made once for all its readers."""
    if "span_index" not in ctx:
        lo, hi = ctx["window_us"]
        ctx["span_index"] = SpanIndex(ctx["events"], lo, hi, ctx["main_tid"])
    return ctx["span_index"]
