"""The benchmark of forest_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell's set-up (weights and inputs
made on the card from the seed, the first steps or batches, the kernels'
first build into ``forest_tpu_torch/csrc/build``) is timed from the
process's start; the window then runs for ``--seconds``; with ``--trace
1`` two short stretches more run under the profiler (the device's activity
alone, then with the host's operators). The last line on
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checked``: each number compared with the plain reference beside
its limit, which also close standard error. The run refuses (exit 2, no
result) without a CUDA device, and fails (exit 3, no result) if JAX or the
JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one thread for torch's work on the host, set before torch is imported:
# the steps run on the card, and idle CPU threads that spin take cores from
# the thread that dispatches them
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "forest_tpu")


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpu_bench import harness
    harness.set_env(ROOT)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == a.workload),
                 None)
    if entry is None:
        print(f"no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    harness.log(f"torch imported at {time.perf_counter() - T0:.3f} s, "
                f"{torch.get_num_threads()} host thread(s)")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"no result: the cell needs {entry['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.init()
    harness.log(f"CUDA ready at {time.perf_counter() - T0:.3f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
                f"matmul.allow_tf32 "
                f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 "
                f"{torch.backends.cudnn.allow_tf32}; card: {power_limit()}")
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                         device="cuda", t0=T0, bench=bench)
    bad = loaded_forbidden()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
