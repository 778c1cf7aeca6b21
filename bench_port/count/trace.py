"""Reading a ``torch.profiler`` Chrome trace. The idle-share arithmetic
(the union of the device's kernel, copy and set intervals over a window)
is copied from ``chip_smoke.py`` (``_union_ms``, ``trace_figures``)."""
from __future__ import annotations

import json
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> List[Dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def union_us(intervals, lo: float, hi: float) -> float:
    """Microseconds covered by the union of (start, end) intervals within [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_intervals(events: List[Dict]) -> List[Tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]


def window_of(events: List[Dict], name: str) -> Optional[Tuple[float, float]]:
    """(start, end) in us of the host range named ``name``."""
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == name:
            return e["ts"], e["ts"] + e["dur"]
    return None


def busy_us(events: List[Dict], lo: float, hi: float) -> float:
    return union_us(device_intervals(events), lo, hi)


def top_device_ops(events: List[Dict], lo: float, hi: float, n: int = 10) -> List[List]:
    """[[name, seconds], ...]: device operations by total time in the window."""
    tot = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi:
            tot[e["name"][:160]] += e["dur"] / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: List[Dict], lo: float, hi: float, tid, n: int = 10) -> List[List]:
    """[[host range, seconds], ...]: the device's idle time in the window by
    the innermost host range (``user_annotation``) open on the main thread
    ``tid`` at each gap's start."""
    dev = sorted((max(a, lo), min(b, hi)) for a, b in device_intervals(events) if a < hi and b > lo)
    gaps, end = [], lo
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "user_annotation" and e.get("tid") == tid), key=lambda r: r[0])
    tot = defaultdict(float)
    for g0, g1 in gaps:
        name, width = "(no host range)", math.inf
        for a, b, nm in ranges:
            if a > g0:
                break
            if b > g0 and b - a < width:
                name, width = nm, b - a
        key = name.split("#")[0] + "#" if "#" in name else name
        tot[key] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernel_durations(events: List[Dict], lo: float, hi: float, needle: str) -> List[float]:
    """Seconds of each kernel whose name holds ``needle`` in the window."""
    return [e["dur"] / 1e6 for e in events
            if e.get("cat") == "kernel" and needle in e["name"] and lo <= e["ts"] < hi]


def ranges(events: List[Dict], prefix: str, lo: float, hi: float) -> List[Dict]:
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix) and lo <= e["ts"] < hi), key=lambda e: e["ts"])
