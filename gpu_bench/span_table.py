"""The program's spans in one cell's traced stretches, by span.

    python3 gpu_bench/span_table.py --workload <cell> --seed <n>

Run from the root of a checkout, on a card. Makes the cell's set-up and
its two traced stretches as ``run.py --trace 1`` does (no window and no
comparison with the reference), then prints one JSON object: the device
stretch's busy and host seconds, the operator stretch's host ms a unit,
and ``gpu_bench.spans.table`` of the operator stretch: for ``unit`` and
each program span, a unit's device ms, idle ms, device events launched and
host synchronisations inside it.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def traced_cell(name: str, seed: int, device, workload=None, units=None):
    """The cell ``name``'s set-up and its two traced stretches of
    ``units`` units (the workload's ``trace_units`` by default) as
    ``run.py --trace 1`` makes them: ``harness.traced``'s (busy, Trace).
    ``workload`` defaults to the checkout's file."""
    import importlib

    import torch

    from gpu_bench import harness
    dev = torch.device(device)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    wl = workload or harness.load_json(harness.BENCH / "workloads"
                                       / f"{name}.json")
    cfg = harness.load_json(harness.BENCH / "configs"
                            / f"{entry['config']}.json")
    units = int(wl["traffic"]["trace_units"]) if units is None else units
    driver = importlib.import_module(f"gpu_bench.drivers.{wl['driver']}")
    cell = driver.Cell(cfg, wl, seed, dev)
    cell.setup()
    return harness.traced(cell, units, 0, dev)


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"           # before torch loads, as run.py
    sys.path.insert(0, str(ROOT))
    import torch

    from gpu_bench import harness, spans
    harness.set_env(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    busy, tr = traced_cell(a.workload, a.seed, "cuda")
    print(json.dumps({"cell": a.workload, "seed": a.seed,
                      "units": busy.units, "busy_s": busy.busy_s,
                      "window_s": busy.window_s,
                      "operator_ms_per_unit": 1e3 * tr.window_s / busy.units,
                      "spans": spans.table(tr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
