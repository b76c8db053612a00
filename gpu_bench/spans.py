"""Reading the program's own spans in the operator stretch's trace.

The port marks its layers with ``record_function`` ranges named
``<layer>.<part>`` (``forest_tpu_torch/utils/spans.py``): ``step.forward``,
``step.backward``, ``step.update``, ``model.type_encoder``, ``data.features``
and others. They are ``user_annotation`` events of the same Kineto trace as
the device's kernels, copies and sets, on their clock.

A span's intervals are the union of every range of its name inside the
window, so a span nested in one of its own name counts once. A device event
belongs to the span when its launch (the runtime or driver call with the
same ``correlation``) started inside one of those intervals, on any thread:
autograd launches the backward's kernels from its own device thread, not
from the thread that holds ``step.backward``. A span's idle time is the
host time inside its intervals with nothing on the device. Each reading is
a unit's share, over the trace's ``unit`` spans; a trace without the span,
without units or without device activity reads None.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from gpu_bench.trace import SYNC_CALLS, Trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
Intervals = List[Tuple[float, float]]


def union(iv: Sequence[Tuple[float, float]]) -> Intervals:
    """Sorted, disjoint intervals covering ``iv``."""
    out: Intervals = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intervals(trace: Trace, name: str) -> Intervals:
    """The union of the ranges named ``name`` inside the window, in us."""
    return union([(e["ts"], e["ts"] + e["dur"]) for e in trace.host
                  if e.get("cat") == "user_annotation"
                  and e["name"] == name and trace.in_window(e)])


def inside(iv: Intervals, t: float) -> bool:
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and t <= iv[i][1]


def overlap(x: Intervals, y: Intervals) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, b - a)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def launched_inside(trace: Trace, iv: Intervals) -> List[Dict]:
    """The device events whose launch started inside ``iv``."""
    launch = {e["args"]["correlation"]: e["ts"] for e in trace.host
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    out = []
    for e in trace.device:
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None and inside(iv, t):
            out.append(e)
    return out


def _span(trace: Optional[Trace], name: str) -> Optional[Intervals]:
    if trace is None or not trace.units or not trace.device:
        return None
    return intervals(trace, name) or None


def device_ms(trace: Optional[Trace], name: str) -> Optional[float]:
    """Device ms a unit of the work launched inside the span ``name``."""
    iv = _span(trace, name)
    if iv is None:
        return None
    return sum(e["dur"] for e in launched_inside(trace, iv)) \
        / 1e3 / len(trace.units)


def idle_ms(trace: Optional[Trace], name: str) -> Optional[float]:
    """Host ms a unit inside the span ``name`` with nothing on the
    device."""
    iv = _span(trace, name)
    if iv is None:
        return None
    host = sum(b - a for a, b in iv)
    return (host - overlap(iv, trace.busy_intervals())) \
        / 1e3 / len(trace.units)


def table(trace: Trace) -> Dict[str, Dict[str, float]]:
    """For ``unit`` and every program span of the trace, a unit's device
    ms, idle ms, device events launched and host synchronisations (any
    thread) inside it."""
    names = sorted({e["name"] for e in trace.host
                    if e.get("cat") == "user_annotation"} - {"finish"})
    syncs = [e["ts"] for e in trace.host if e.get("cat") == "cuda_runtime"
             and e["name"] in SYNC_CALLS]
    n = max(len(trace.units), 1)
    out = {}
    for name in names:
        iv = intervals(trace, name)
        out[name] = {
            "device_ms": device_ms(trace, name),
            "idle_ms": idle_ms(trace, name),
            "launches": len(launched_inside(trace, iv)) / n,
            "syncs": sum(inside(iv, t) for t in syncs) / n}
    return out
