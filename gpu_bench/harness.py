"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``workloads/<cell>.json`` (its configuration, driver, traffic parameters
and limits), ``configs/<config>.json``, ``drivers/<driver>.py`` and a
metric's reader: ``metrics/<metric>.py``, else ``metrics/<kind>.py`` for
a metric named ``<kind>.<anything>``. A cell reports the end-to-end
metrics of ``BENCHMARK.json`` that list it (or list no cells) with
``--trace 0``, and likewise its per-layer metrics with ``--trace 1``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch

from gpu_bench import trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def log(msg: str) -> None:
    print(f"[gpu_bench] {msg}", file=sys.stderr, flush=True)


class Laps:
    """Logs the seconds since its last call, each named, on standard
    error: where a set-up's time goes."""

    def __init__(self, device: torch.device):
        self.device, self.t = device, time.perf_counter()

    def __call__(self, what: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        log(f"set-up: {what} {now - self.t:.3f} s")
        self.t = now


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports in a run with or without ``trace``."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m
                                           and m["moves"] in e2e)]


def reader(name: str):
    """The module ``metrics/<name>.py``, else ``metrics/<kind>.py`` where
    ``name`` is ``<kind>.<anything>``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_info(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seconds: float, device: torch.device) -> SimpleNamespace:
    """Timed units back to back until ``seconds`` have passed, then the
    cell's closing fetch and a synchronise: the window."""
    spans: List[float] = []
    failed = 0
    t_start = time.perf_counter()
    while True:
        t = time.perf_counter()
        failed += cell.unit(len(spans))
        spans.append(time.perf_counter() - t)
        if time.perf_counter() - t_start >= seconds:
            break
    failed += cell.finish()
    synchronize(device)
    window_s = time.perf_counter() - t_start
    return SimpleNamespace(spans=spans, units=len(spans), failed=failed,
                           seconds=window_s,
                           items=cell.unit_items * (len(spans) - failed))


def _stretch(cell, units: int, first: int, device: torch.device,
             activities, **kw) -> Tuple[List[Dict], float]:
    """``units`` more units and the closing fetch under the profiler with
    ``activities``: the Chrome trace's events, written under the run's
    temporary directory and read back, and the stretch's host seconds."""
    from torch.profiler import profile, record_function
    synchronize(device)
    with profile(activities=activities, **kw) as prof:
        t = time.perf_counter()
        for i in range(units):
            with record_function("unit"):
                cell.unit(first + i)
        with record_function("finish"):
            cell.finish()
            synchronize(device)
        seconds = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = load_json(path)["traceEvents"]
    return events, seconds


def traced(cell, units: int, first: int, device: torch.device
           ) -> Tuple[SimpleNamespace, trace_mod.Trace]:
    """Two stretches of ``units`` units after the window. The first traces
    the device's activity alone, which slows the host least: its device
    busy time and host time are the result's ``busy_s`` and ``window_s``
    and give the idle share. The second also records the host's operators
    with their shapes, for the kernels' op attribution, the
    synchronisations and the breakdown; it slows a host-bound unit down
    more, so no time share is read from it."""
    from torch.profiler import ProfilerActivity
    light = [ProfilerActivity.CUDA if device.type == "cuda"
             else ProfilerActivity.CPU]
    events, seconds = _stretch(cell, units, first, device, light)
    busy = SimpleNamespace(units=units, window_s=seconds,
                           busy_s=trace_mod.Trace(events).busy_s())
    log(f"device stretch: {units} units, {seconds:.4f} s, device busy "
        f"{busy.busy_s:.4f} s")
    full = [ProfilerActivity.CPU]
    if device.type == "cuda":
        full.append(ProfilerActivity.CUDA)
    events, seconds = _stretch(cell, units, first + units, device, full,
                               record_shapes=True)
    log(f"operator stretch: {units} units, {seconds:.4f} s")
    return busy, trace_mod.Trace(events)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: Optional[float] = None,
        bench: Optional[Dict] = None,
        workload: Optional[Dict] = None) -> Dict:
    """One run of ``cell_name``. ``bench`` / ``workload`` default to the
    checkout's files; ``t0`` is the process's start on the
    ``time.perf_counter`` clock."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell_name)
    wl = workload or load_json(BENCH / "workloads" / f"{cell_name}.json")
    cfg = load_json(BENCH / "configs" / f"{entry['config']}.json")
    driver = importlib.import_module(f"gpu_bench.drivers.{wl['driver']}")
    cell = driver.Cell(cfg, wl, seed, dev)
    flops = cell.flops()
    log(f"cell {cell_name} seed {seed}: {sum(flops.values()) / 1e9:.4f} "
        f"GFLOP a unit by the benchmark's count ({json.dumps(flops)})")
    log(f"set-up begins at {time.perf_counter() - t0:.3f} s")
    cell.setup()
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    own0 = time.process_time()
    window = measure(cell, seconds, dev)
    log(f"window: {window.units} units, {window.failed} failed, "
        f"{window.seconds:.3f} s; the process's CPU time "
        f"{time.process_time() - own0:.3f} s")
    busy = tr = None
    if trace:
        busy, tr = traced(cell, int(wl["traffic"]["trace_units"]),
                          window.units, dev)
    info = device_info(dev)
    cell.release()
    checks = cell.check()
    correct = all(v <= lim for _, v, lim in checks)
    ctx = SimpleNamespace(setup_s=setup_s, window=window, busy=busy,
                          trace=tr, flops=flops, traffic=wl["traffic"])
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": window.units,
              "failed": window.failed, "metrics": metrics, "device": info}
    if trace:
        result["device"]["busy_s"] = busy.busy_s
        result["device"]["window_s"] = busy.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.longest_gaps()}
    result["checked"] = {name: {"value": v, "limit": lim}
                         for name, v, lim in checks}
    for name, v, lim in checks:
        log(f"check {name} = {v!r} (limit {lim!r})"
            f"{'' if v <= lim else '  FAILS'}")
    return result


def set_env(root: Path) -> None:
    """Fixed cache directories inside the checkout for what a run may build
    besides the port's own kernels (``forest_tpu_torch/csrc/build``), and
    no JAX, TensorFlow or Flax behind a library's back."""
    base = root / ".bench_cache"
    os.environ.update({"TRITON_CACHE_DIR": str(base / "triton"),
                       "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
                       "USE_FLAX": "0", "USE_TF": "0", "USE_JAX": "0"})
