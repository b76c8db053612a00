"""The readings that the limits of ``correct`` are set from, for one cell
at its own size, over several seeds in one process.

    python3 gpu_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--out FILE]

For each seed: the port's readings as a run takes them (the training
cells' first steps; the embedding cell's checked batches), each against
the plain reference; the control, the reference computed with TF32 for its
float32 products (the precision below the configuration's), against the
reference; and each fault the cell can have, planted in the reference put
in the port's place: a training step that leaves half the batch out and
takes its mean over the rest, or an embedding altered where it is made.
One JSON line a seed on standard output (and to ``--out``).
"""
import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _training(cell):
    from gpu_bench.drivers import _training as tr
    cell.setup()
    port = cell.port_readings
    cell.release()
    ref = cell.reference_readings()
    ctl = cell.reference_readings(tf32=True)
    half = cell.reference_readings(half_batch=True)
    leaves = tr.moving_leaves(ref["grad1"])

    def values(readings):
        out = tr.gaps(readings, ref)
        out["loss_steps"] = [abs(p - r) / abs(r) for p, r in
                             zip(readings["loss"], ref["loss"])]
        for key in ("grad1", "change"):
            v, leaf = tr.worst_leaf(readings[key], ref[key], leaves)
            out[f"{key}_worst"] = [leaf, ref[key][leaf]]
        return out
    out = {"port": values(port), "control": values(ctl),
           "half_batch": values(half),
            "median_leaf": {k: sorted(ref[k][n] for n in leaves)[
                len(leaves) // 2] for k in ("grad1", "change")},
            "left_out": sorted(set(ref["grad1"]) - set(leaves))}
    return out


def _embedding(cell):
    import torch
    cell.setup()
    for i in range(cell.traffic["checked"]):
        cell.unit(i)
    cell.release()
    port = cell.gaps()
    ctl = cell.gaps(tf32=True)
    # the fault: one pixel's z_type of each checked batch moved by the
    # batch's largest magnitude, as a wrong answer made where it is made
    with torch.inference_mode():
        for _, (zt, _) in cell.kept:
            zt[0, 0, 0] += zt.abs().max()
    altered = cell.gaps()
    return {"port": port, "control": ctl, "altered": altered}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gpu_bench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = harness.load_json(ROOT / "gpu_bench" / "workloads"
                           / f"{a.workload}.json")
    cfg = harness.load_json(ROOT / "gpu_bench" / "configs"
                            / f"{wl['config']}.json")
    driver = importlib.import_module(f"gpu_bench.drivers.{wl['driver']}")
    limits = {k: math.inf for k in wl["limits"]}
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        cell = driver.Cell(cfg, dict(wl, limits=limits), seed,
                           torch.device("cuda"))
        fn = _embedding if wl["driver"].startswith("embed") else _training
        res = {"workload": a.workload, "seed": seed, **fn(cell),
               "seconds": time.perf_counter() - t}
        line = json.dumps(res)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
