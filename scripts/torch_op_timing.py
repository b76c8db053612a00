"""Host cost of the port's kernels' public calls, and the training steps'
times, on one card.

    PYTHONPATH=. python scripts/torch_op_timing.py [--split] [--steps]

Each public call of K1-K5 (``ops.smoothing.bank_mix`` alone and with its
gradient, ``bank_mix_bwd``, ``ops.scatter.scatter_add_rows`` as the
training step calls it, ``extract_rows`` with its gradient,
``ops.vq.vq_core`` and ``vq_assign``) at tiny shapes, where the device
work is negligible: microseconds a call, the least of three windows of
3,000 calls.

With ``--split``, where each call's host time goes: for K1-K5 the public
call, the ``torch.ops.forest_tpu_torch`` op called directly (the public
function's checks left out) and the op's CUDA body called directly (the
dispatcher left out too); and ``vq_core``'s output allocations alone, as
five tensors (an op's outputs may not alias) and as one buffer cut into
four views. Needs a tree whose kernels are ``torch.library`` ops.

With ``--steps``, the FRL train step as ``chip_smoke.py`` phase 8 builds
it (B 12, 256², every loss of ``DEFAULT_WEIGHTS``; 3 warm steps, then 20)
and the VQ-VAE step as phase 12 builds it (10 warm, then 100), each step
timed by the host clock to a synchronise: median, least and 90th
percentile ms.

Without ``--split`` it calls only what every tree of the port has (the
public functions, and with ``--steps`` the tree's
``chip_smoke.build_train_step`` and ``build_vqvae_step``), so it also times
another tree, run from that tree's root:

    cd <tree> && PYTHONPATH=. python <this tree>/scripts/torch_op_timing.py

Two trees compare only within one call, in turns (A B B A). The card's
name and power limit come first; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch


def host_us(fn, calls: int = 3000, windows: int = 3) -> float:
    """Microseconds a call of ``fn``: the least of ``windows`` windows of
    ``calls`` calls, each window ended by a synchronise."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def step_ms(fn, warm: int, steps: int) -> dict:
    """Median, least and 90th percentile ms of ``steps`` calls of ``fn``
    after ``warm``, each timed to a synchronise."""
    for _ in range(warm):
        fn()
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    return {"median": ms[len(ms) // 2], "min": ms[0],
            "p90": ms[int(0.9 * len(ms))]}


def op_calls() -> dict:
    """Microseconds a public call of each kernel, as :func:`host_us`."""
    from forest_tpu_torch.ops import scatter as sc
    from forest_tpu_torch.ops import smoothing as sm
    from forest_tpu_torch.ops import vq
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(1, 4, 4, 2)
    a = torch.softmax(randn(1, 4, 4, 8, 4), 3)
    b = torch.softmax(randn(1, 4, 4, 2, 4), 4)
    g = torch.randn_like(x)
    xg = x.clone().requires_grad_(True)
    grid = randn(2, 64, 4).requires_grad_(True)
    idx = torch.randint(0, 64, (2, 16), device="cuda", generator=gen)
    dz = randn(2, 16, 4)
    xv, cv = randn(64, 128), randn(256, 128)
    calls = {
        "bank_mix": lambda: sm.bank_mix(x, a, b),
        "bank_mix with its gradient": lambda: torch.autograd.grad(
            sm.bank_mix(xg, a, b), xg, g),
        "bank_mix_bwd": lambda: sm.bank_mix_bwd(x, a, b, g),
        "scatter_add_rows": lambda: sc.scatter_add_rows(
            dz, idx, 64, check_index=False),
        "extract_rows with its gradient": lambda: torch.autograd.grad(
            sc.extract_rows(grid, idx).sum(), grid),
        "vq_core": lambda: vq.vq_core(xv, cv),
        "vq_assign": lambda: vq.vq_assign(xv, cv)}
    return {name: host_us(fn) for name, fn in calls.items()}


def split_calls() -> dict:
    """{kernel: {"public", "op", "body": us}} for K1-K5 (see the module's
    docstring), and ``vq_core``'s output allocations alone as
    ``{"vq_core allocations": {"five tensors", "one buffer": us}}``."""
    from forest_tpu_torch.ops import scatter as sc
    from forest_tpu_torch.ops import smoothing as sm
    from forest_tpu_torch.ops import vq
    ops = torch.ops.forest_tpu_torch
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(1, 4, 4, 2)
    a = torch.softmax(randn(1, 4, 4, 8, 4), 3)
    b = torch.softmax(randn(1, 4, 4, 2, 4), 4)
    g = torch.randn_like(x)
    idx = torch.randint(0, 64, (2, 16), device="cuda", generator=gen)
    dz = randn(2, 16, 4)
    xv, cv = randn(64, 128), randn(256, 128)
    calls = {
        "bank_mix": (lambda: sm.bank_mix(x, a, b),
                     lambda: ops.bank_mix_fwd(x, a, b, 4, 3),
                     lambda: sm._launch_fwd(x, a, b, 4, 3)),
        "bank_mix_bwd": (lambda: sm.bank_mix_bwd(x, a, b, g),
                         lambda: ops.bank_mix_bwd(x, a, b, g, 4, 3),
                         lambda: sm._launch_bwd(x, a, b, g, 4, 3)),
        "scatter_add_rows": (
            lambda: sc.scatter_add_rows(dz, idx, 64, check_index=False),
            lambda: ops.scatter_add_rows(dz, idx, 64),
            lambda: sc._launch(dz, idx, 64)),
        "vq_core": (lambda: vq.vq_core(xv, cv),
                    lambda: ops.vq_core(xv, cv, False),
                    lambda: vq._launch_core(xv, cv, False)),
        "vq_assign": (lambda: vq.vq_assign(xv, cv),
                      lambda: ops.vq_assign(xv, cv, False),
                      lambda: vq._launch_assign(xv, cv, False))}
    out = {name: dict(zip(("public", "op", "body"), map(host_us, fns)))
           for name, fns in calls.items()}
    n, d = xv.shape
    k = cv.shape[0]
    f32 = dict(dtype=torch.float32, device="cuda")
    nbytes, _ = vq.vq_core_scratch(n, d, k)

    def five():
        return (torch.empty(n, dtype=torch.int32, device="cuda"),
                torch.empty(n, d, **f32), torch.empty(k, **f32),
                torch.empty(k, d, **f32), torch.empty((), **f32),
                torch.empty(nbytes, dtype=torch.uint8, device="cuda"))

    def one():
        buf = torch.empty(n * d + n + k + k * d + 1, **f32)
        return (buf[:n * d].view(n, d), buf[n * d:n * d + n].view(torch.int32),
                buf[n * d + n:n * d + n + k],
                buf[n * d + n + k:n * d + n + k + k * d].view(k, d), buf[-1],
                torch.empty(nbytes, dtype=torch.uint8, device="cuda"))

    out["vq_core allocations"] = {"five tensors": host_us(five),
                                  "one buffer": host_us(one)}
    return out


def steps() -> dict:
    """The FRL and VQ-VAE train steps' times, as :func:`step_ms`."""
    import chip_smoke as cs
    from forest_tpu_torch.data.cube import build_synthetic_cube
    t = cs.build_train_step("cuda")
    out = {"frl_ms": step_ms(lambda: t.train_step(
        t.state, t.batch, t.gen, t.weights, t.curriculum), 3, 20)}
    del t
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        zarr = Path(d) / "cube.zarr"
        build_synthetic_cube(zarr, height=256, width=256,
                             years=tuple(range(2017, 2022)), n_cont=8,
                             n_cat=2, n_naip=3, seed=cs.SEED)
        k = cs.build_vqvae_step(zarr, Path(d) / "run", "cuda")
        out["vqvae_ms"] = step_ms(lambda: k.train_step(
            k.state, k.batch, k.weights), 10, 100)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="split each call's host time: checks, dispatcher, "
                         "body; and vq_core's allocations")
    ap.add_argument("--steps", action="store_true",
                    help="time the FRL and VQ-VAE train steps too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_op_timing: no CUDA device")
    import forest_tpu_torch
    from forest_tpu_torch.ops import _cuda_build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _cuda_build.load_libraries(["bank_mix_fwd", "bank_mix_bwd",
                                "scatter_add_rows", "vq_assign"])
    res = {"card": card, "package": str(Path(forest_tpu_torch.__file__)
                                        .parent),
           "call_us": op_calls()}
    if args.split:
        res["split_us"] = split_calls()
    if args.steps:
        res.update(steps())
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
