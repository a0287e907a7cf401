"""Reduce a ``torch.profiler`` chrome trace of the measured window to what
the per-layer metrics and the ``breakdown`` read.

The window is the harness's ``ssvbench.window`` span. Device activity is
every kernel, copy and fill the trace holds (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``), clipped to the window. An idle gap is an
interval of the window that no device activity covers; it is labelled by
the harness span around it and by the recorded host event (any thread)
that overlaps it most.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "ssvbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # (name, seconds), most first
    idle_gaps: List[Tuple[str, float]]  # (label, seconds), longest first
    kernel_s: Dict[str, float] = field(default_factory=dict)  # all names

    def seconds_of(self, substring: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if substring in name)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted cover of ``intervals``."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Tuple[float, float]], w0: float, w1: float
         ) -> List[Tuple[float, float]]:
    """The parts of [w0, w1] that the disjoint sorted ``busy`` leaves."""
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def _label(g0: float, g1: float, spans, host) -> str:
    mid = (g0 + g1) / 2
    inside = [e for e in spans if e[0] <= mid <= e[1]]
    span = min(inside, key=lambda e: e[1] - e[0])[2] if inside else "-"
    best, over = None, 0.0
    for a, b, name in host:
        o = min(b, g1) - max(a, g0)
        if o > over:
            best, over = name, o
    return f"{span} / {best or 'no recorded host event'}"


def _device(complete: List[dict], w0: float, w1: float
            ) -> Tuple[List[Tuple[float, float]], Dict[str, float]]:
    """The device activity clipped to [w0, w1]: its intervals, and its
    seconds by name."""
    device, kernel_s = [], {}
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        device.append((a, b))
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (b - a) * 1e-6
    return device, kernel_s


def reduce_events(events: List[dict]) -> TraceSummary:
    """The summary of a chrome trace's ``traceEvents``; times in seconds."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == WINDOW_SPAN]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, kernel_s = _device(complete, w0, w1)
    busy = union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in complete if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ssvbench.")]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in complete if e.get("cat") in HOST_CATS
            and not str(e.get("name", "")).startswith("ssvbench.")]
    idle = sorted(gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:TOP]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        device_ops=sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(_label(a, b, spans, host), (b - a) * 1e-6)
                   for a, b in idle],
        kernel_s=kernel_s)


def reduce_file(path: str) -> TraceSummary:
    with open(path) as f:
        return reduce_events(json.load(f)["traceEvents"])


def busy_seconds(events: List[dict]) -> float:
    """Seconds of the union of the trace's device activity, clipped to the
    window's span where the trace holds one. A profiler of device activity
    alone records no host span; it is started and stopped around the
    window, and all that it holds is the window's."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == WINDOW_SPAN]
    if windows:
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        w0, w1 = float("-inf"), float("inf")
    device, _ = _device(complete, w0, w1)
    return sum(b - a for a, b in union(device)) * 1e-6


def busy_file(path: str) -> float:
    with open(path) as f:
        return busy_seconds(json.load(f)["traceEvents"])
