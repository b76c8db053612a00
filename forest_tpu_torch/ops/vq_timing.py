"""Times and fingerprints of the VQ assignment kernels on one card.

    python -m forest_tpu_torch.ops.vq_timing [--runs 50]

At N 131072, D 128, K 256 (seeded Gaussian x and codebook) it times K4
``vq_core`` (with and without sum(q * x)), K5 ``vq_assign`` (float32 and
bfloat16 operands), K6 (the sweep's row-major variant at the TPU tile 512,
float32 and bfloat16-rounded operands), K7 (x pre-transposed, float32 and
bfloat16-rounded operands, at the TPU tiles 512, 1024, 2048 and 4096) and the PyTorch compositions
(``addmm`` + ``argmin``, ``matmul`` + ``argmin``): each the median of
CUDA-event timings of single calls. Then it prints the sha256 of every
kernel's outputs, so that two trees' results compare bit for bit. It calls
only functions every tree of the port has, so it also runs another tree's
package:

    PYTHONPATH=<other tree> python forest_tpu_torch/ops/vq_timing.py

The card's name and power limit come first; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

N, D, K = 131072, 128, 256
TILES = (512, 1024, 2048, 4096)


def median_ms(fn, runs: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def digest(out) -> str:
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vq_timing: no CUDA device")
    from forest_tpu_torch.ops import vq
    from forest_tpu_torch.ops import vq_variants as vv
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, device="cuda", generator=gen)
    c = torch.randn(K, D, device="cuda", generator=gen)
    xt = x.t().contiguous()
    ops = {
        "K4 vq_core": lambda: vq.vq_core(x, c),
        "K4 vq_core with_qx": lambda: vq.vq_core(x, c, with_qx=True),
        "K5 f32": lambda: vq.vq_assign(x, c),
        "K5 bf16": lambda: vq.vq_assign(x, c, mxu_bf16=True),
        "K6 f32 512": lambda: vv.make_assign(512, False)(x, c),
        "K6 bf16 512": lambda: vv.make_assign(512, True)(x, c),
    }
    for tile in TILES:
        for name, mxu in (("f32", False), ("bf16", True)):
            ops[f"K7 {name} {tile}"] = (
                lambda t=tile, m=mxu:
                vv.make_assign_t(t, m, torch.float32, True)(xt, c))
    ops["addmm + argmin"] = lambda: torch.addmm(
        (c * c).sum(-1), x, c.t(), alpha=-2.0).argmin(1)
    ops["matmul + argmin"] = lambda: vv.matmul_assign(x, c)
    ms = {name: median_ms(fn, args.runs) for name, fn in ops.items()}
    sha = {name: digest(fn()) for name, fn in ops.items()
           if name.startswith("K")}
    for name in ops:
        print(f"{name:22s} {ms[name]:.4f} ms  {sha.get(name, '')}",
              file=sys.stderr)
    res = {"card": card, "shape": [N, D, K], "runs": args.runs, "ms": ms,
           "sha256_16": sha}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
