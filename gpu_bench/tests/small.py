"""Small shapes of the benchmark's cells, for runs on the CPU."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "frl_v1.train_b12": dict(batch_size=2, patch_size=64, warm=1,
                             trace_units=2, fetch_every=2),
    "frl_v1.embed_b8": dict(batch_size=2, patch_size=64, warm=1,
                            trace_units=2, checked=2),
}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(cell: str) -> dict:
    wl = json.loads((ROOT / "gpu_bench" / "workloads"
                     / f"{cell}.json").read_text())
    wl = copy.deepcopy(wl)
    wl["traffic"].update(SMALL[cell])
    return wl
