"""Reading a ``torch.profiler`` Chrome trace of the traced stretch.

The harness wraps each timed unit in a ``record_function`` span named
``unit`` and the closing synchronise in one named ``finish``. The window is
from the first unit's start to the end of ``finish``, or where a trace
holds no such spans, the extent of the device's activity. Device activity is
every kernel, copy and set on the card; busy time is the union of their
intervals inside the window. A kernel belongs to the port's op
``forest_tpu_torch::<name>`` when its launch ran inside that op: the
profiler gives the kernel the op's "External id", or the kernel's launch
call (same "correlation") lies inside the op's interval on the same thread.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TYPES = {"float": "float32", "c10::BFloat16": "bfloat16",
         "c10::Half": "float16", "double": "float64"}


class Trace:
    def __init__(self, events: List[Dict]):
        self.events = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in self.events if e.get("cat") == "user_annotation"]
        self.units = sorted((e for e in spans if e["name"] == "unit"),
                            key=lambda e: e["ts"])
        finish = [e for e in spans if e["name"] == "finish"]
        self.device = sorted((e for e in self.events
                              if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        # without the harness's spans, the window is the device's activity
        spans_or_device = (self.units + finish) or self.device
        self.start = min((e["ts"] for e in spans_or_device), default=0.0)
        self.end = max((e["ts"] + e["dur"] for e in spans_or_device),
                       default=0.0)
        self.host = [e for e in self.events
                     if e.get("cat") in ("cpu_op", "cuda_runtime",
                                         "cuda_driver", "user_annotation")]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity inside the window, in us."""
        out: List[Tuple[float, float]] = []
        for e in self.device:
            a = max(e["ts"], self.start)
            b = min(e["ts"] + e["dur"], self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def in_window(self, e: Dict) -> bool:
        return self.start <= e["ts"] <= self.end

    def syncs(self) -> int:
        """Host synchronisations made inside the units."""
        starts = [u["ts"] for u in self.units]
        n = 0
        for e in self.host:
            if e.get("cat") != "cuda_runtime" or e["name"] not in SYNC_CALLS:
                continue
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= starts[i] + self.units[i]["dur"]:
                n += 1
        return n

    def top_device_ops(self, k: int = 10) -> List[List]:
        """The device operations that took most time, seconds in all."""
        tot: Dict[str, float] = {}
        for e in self.device:
            if self.in_window(e):
                tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[n[:200], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def host_at(self, ts: float) -> str:
        """The harness span and the innermost host event running at
        ``ts`` (over every thread)."""
        span, inner = "", None
        for e in self.host:
            if e["ts"] <= ts < e["ts"] + e["dur"]:
                if e.get("cat") == "user_annotation" and \
                        e["name"] in ("unit", "finish"):
                    span = e["name"]
                elif inner is None or e["dur"] < inner["dur"]:
                    inner = e
        return f"{span or 'harness'}: {inner['name'] if inner else 'idle'}"

    def longest_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by what the host was doing as it began."""
        busy = self.busy_intervals()
        gaps, at = [], self.start
        for a, b in busy:
            if a > at:
                gaps.append((a - at, at))
            at = max(at, b)
        if self.end > at:
            gaps.append((self.end - at, at))
        gaps.sort(reverse=True)
        return [[self.host_at(t0)[:200], d / 1e6] for d, t0 in gaps[:k]]

    def op_kernels(self, op: str) -> Tuple[List[Dict], float]:
        """The calls of ``forest_tpu_torch::<op>`` inside the window and the
        device seconds of the kernels launched under them."""
        calls = [e for e in self.host if e.get("cat") == "cpu_op"
                 and e["name"] == f"forest_tpu_torch::{op}"
                 and self.in_window(e)]
        if not calls:
            return [], 0.0
        ext = {c["args"].get("External id") for c in calls}
        by_tid: Dict[object, List[Dict]] = {}
        for c in calls:
            by_tid.setdefault(c.get("tid"), []).append(c)
        launch = {e["args"].get("correlation"): e for e in self.host
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")}
        seconds = 0.0
        for e in self.device:
            if e.get("cat") != "kernel":
                continue
            args = e.get("args", {})
            hit = args.get("External id") in ext
            if not hit:
                call = launch.get(args.get("correlation"))
                hit = call is not None and any(
                    c["ts"] <= call["ts"] <= c["ts"] + c["dur"]
                    for c in by_tid.get(call.get("tid"), ()))
            if hit:
                seconds += e["dur"] / 1e6
        return calls, seconds


def input_dims(call: Dict) -> Tuple[List[Tuple[int, ...]], str]:
    """An op call's input shapes and its first input's type."""
    args = call.get("args", {})
    dims = [tuple(d) for d in args.get("Input Dims", [])]
    types = args.get("Input type", [])
    return dims, TYPES.get(types[0] if types else "float", "float32")


def roofline_pct(trace: Trace, op: str, cost) -> Optional[float]:
    """100 x the least time of every call of ``op`` (``cost(dims, dtype)``
    -> seconds) over the device time of the kernels launched under them;
    None where no kernel of the op was seen."""
    calls, seconds = trace.op_kernels(op)
    if not calls or seconds <= 0.0:
        return None
    least = sum(cost(*input_dims(c)) for c in calls)
    return 100.0 * least / seconds
