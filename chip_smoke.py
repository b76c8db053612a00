"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernel ``bank_mix_fwd`` from ``forest_tpu_torch/csrc``;
3. hold the kernel to its plain PyTorch version on the card at the serving
   shape [8, 256, 256, 48] (R = 4, coarse dilation 3) in float32 and
   bfloat16 and at an odd shape [2, 33, 37, 5], and time both;
4. build the v1 encoder from ``configs/frl_repr_model_v1.yaml`` with seeded
   random weights, write it as a flax-layout checkpoint with the synthetic
   bindings and stats into a temporary directory;
5. serve it with ``forest_tpu_torch.serving.EncoderService`` (device cuda,
   max batch 8) behind the HTTP front and POST concurrent 256 x 256
   requests, some with dense phase embeddings; check shapes and finiteness;
6. check the serving run launched the kernel, and that one response equals
   the same model run with the plain version of the kernel, within the
   bfloat16 bound below.

The line before the last is a JSON object with the kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result. Imports nothing of JAX: the script
names only ``forest_tpu_torch``, which shares the JAX package's host code
that imports no JAX (bindings parser, synthetic cube, HTTP front).
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "forest_tpu_torch/csrc/bank_mix_fwd.cu"
KERNEL_REPLACES = "forest_tpu/ops/smoothing.py:181"  # _fwd_kernel
SERVE_SHAPE = (8, 256, 256, 48)
ODD_SHAPE = (2, 33, 37, 5)
RANK, COARSE_DILATION, NUM_DIRECTIONS = 4, 3, 4
T_STEPS = 15          # data.cube_v2.synthetic_bindings' annual window
SEED = 0
# Kernel vs plain version. float32: the same f32 sums in another order.
# bfloat16: both round an f32 result once, so they differ by at most one
# bf16 ulp, 2^-7 of the largest magnitude.
F32_BOUND = 1e-5
BF16_ULP = 2.0 ** -7
# Served z_type / z_phase with the kernel vs with the plain version: the
# smoothing block runs in bf16, so one-ulp differences of the bank pass
# through the bf16 gate convs; bound on max |diff| / max |ref|.
SERVE_REL_BOUND = 2.0 ** -5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings of single calls."""
    import torch
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
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(shape, dtype, generator):
    import torch
    b, h, w, c = shape
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=generator)
    a_w = torch.softmax(torch.randn(b, h, w, 2 * NUM_DIRECTIONS, RANK,
                                    device=dev, generator=generator), 3)
    b_w = torch.softmax(torch.randn(b, h, w, c, RANK, device=dev,
                                    generator=generator), 4)
    return (x.to(dtype).contiguous(), a_w.to(dtype).contiguous(),
            b_w.to(dtype).contiguous())


def check_kernel(shape, dtype, generator, timed: bool) -> dict:
    import torch
    from forest_tpu_torch.ops import smoothing as sm
    x, a_w, b_w = kernel_inputs(shape, dtype, generator)
    kw = dict(num_directions=NUM_DIRECTIONS, coarse_dilation=COARSE_DILATION)
    out = sm.bank_mix(x, a_w, b_w, **kw)
    torch.cuda.synchronize()
    ref = sm.bank_mix_reference(x, a_w, b_w, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    bound = F32_BOUND if dtype == torch.float32 else BF16_ULP * scale
    res = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "bound": bound}
    if timed:
        res["ms"] = cuda_ms(lambda: sm.bank_mix(x, a_w, b_w, **kw))
        res["plain_ms"] = cuda_ms(
            lambda: sm.bank_mix_reference(x, a_w, b_w, **kw), runs=5)
    log(f"kernel check {json.dumps(res)}")
    if not err <= bound:
        raise AssertionError(f"bank_mix_fwd disagrees with its plain version"
                             f" at {shape} {dtype}: {err} > {bound}")
    return res


def write_checkpoint(tmp: Path):
    """v1 model with seeded weights -> flax-layout checkpoint, bindings YAML
    and stats JSON in ``tmp``. Returns (checkpoint, bindings path)."""
    import torch
    import yaml

    from forest_tpu_torch.data import (parse_bindings, synthetic_bindings,
                                       synthetic_feature_stats)
    from forest_tpu_torch.models import representation as rep
    from forest_tpu_torch.training.checkpointing import save_state
    from forest_tpu_torch.utils.flax_bridge import params_to_flax

    cfg = yaml.safe_load((ROOT / "configs/frl_repr_model_v1.yaml")
                         .read_text())
    raw = synthetic_bindings(tmp / "cube.zarr", tmp / "stats.json")
    bindings = parse_bindings(raw)
    type_in = len(bindings.get_feature("type_encoder_input").channels)
    phase_in = len(bindings.get_feature("phase_ccdc").channels)
    model = rep.from_config(cfg, type_in, phase_in)
    rep.init_parameters(model, torch.Generator().manual_seed(SEED))
    ckpt = tmp / "encoder_v1.msgpack"
    save_state(ckpt, {"params": params_to_flax(model.state_dict())},
               {"model_config": rep.model_config_dict(model),
                "type_in_channels": type_in, "phase_in_channels": phase_in})
    (tmp / "stats.json").write_text(json.dumps(
        synthetic_feature_stats(bindings)))
    bpath = tmp / "bindings.yaml"
    bpath.write_text(yaml.safe_dump(raw))
    log(f"checkpoint: v1 config, type_in={type_in} phase_in={phase_in} "
        f"T={T_STEPS}, {sum(p.numel() for p in model.parameters())} params")
    return ckpt, bpath


def make_patches(n: int, hw: int):
    import numpy as np

    from forest_tpu_torch.data import synthetic_frl_batch
    batch = synthetic_frl_batch(np.random.default_rng(SEED), b=n, hw=hw,
                                t=T_STEPS)
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def post(url: str, body: bytes):
    from forest_tpu_torch.serving import unpack_npz
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = unpack_npz(resp.read())
    return out, (time.perf_counter() - t0) * 1e3


def burst(base: str, bodies, phases):
    """POST all bodies at once from threads; -> (outputs, latencies ms,
    wall ms)."""
    results = [None] * len(bodies)
    errors = []

    def one(i):
        try:
            q = "?phase=1" if phases[i] else ""
            results[i] = post(f"{base}/v1/encode{q}", bodies[i])
        except Exception as e:  # reported below, fails the phase
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = (time.perf_counter() - t0) * 1e3
    if errors or any(r is None for r in results):
        raise RuntimeError(f"requests failed: {errors}")
    return [r[0] for r in results], [r[1] for r in results], wall


def serve_and_check(ckpt: Path, bpath: Path, patches,
                    device: str = "cuda") -> dict:
    import numpy as np

    from forest_tpu_torch.ops import smoothing as sm
    from forest_tpu_torch.serving import EncoderService, make_server, pack_npz

    svc = EncoderService(ckpt, bpath, device=device, max_batch=8)
    srv = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    n = len(patches)
    try:
        bodies = [pack_npz(p) for p in patches]
        type_only = [False] * n
        mixed = [i % 2 == 1 for i in range(n)]
        sm.bank_mix.launches = 0
        _, warm_ms, _ = burst(base, bodies[:1], [True])  # first use
        outs, lat_t, wall_t = burst(base, bodies, type_only)
        outs_m, lat_m, wall_m = burst(base, bodies, mixed)
        launches = sm.bank_mix.launches
        batches = svc.batches_run
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
        svc.close()
    log(f"served {2 * n + 1} requests in {batches} batches, "
        f"kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("serving never launched bank_mix_fwd")
    hw = patches[0]["static"].shape[0]
    for i, o in enumerate(outs + outs_m):
        want = {"z_type": (hw, hw, 48)}
        if i >= n and mixed[i - n]:
            want["z_phase"] = (T_STEPS, hw, hw, 8)
        got = {k: tuple(v.shape) for k, v in o.items()}
        if got != want:
            raise AssertionError(f"response {i}: shapes {got} != {want}")
        if not all(np.isfinite(v).all() for v in o.values()):
            raise AssertionError(f"response {i}: non-finite values")
    return {"launches": launches, "batches_run": batches,
            "first_request_ms": warm_ms[0],
            "burst_type_only": {"requests": n, "wall_ms": wall_t,
                                "latency_ms_median": sorted(lat_t)[n // 2],
                                "latency_ms_max": max(lat_t)},
            "burst_mixed_phase": {"requests": n, "wall_ms": wall_m,
                                  "latency_ms_median": sorted(lat_m)[n // 2],
                                  "latency_ms_max": max(lat_m)},
            "checked": outs_m[1]}


def check_against_plain(ckpt: Path, bpath: Path, patch, served,
                        device: str = "cuda") -> dict:
    """Run the served model on one patch with the kernel and with its plain
    version swapped in; compare both to the HTTP response."""
    import numpy as np
    import torch

    from forest_tpu_torch.data import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.eval.frozen import load_frozen_model
    from forest_tpu_torch.models import spatial
    from forest_tpu_torch.ops import smoothing as sm

    model = load_frozen_model(ckpt, device)
    fb = FeatureBuilder(parse_bindings(str(bpath)))
    groups = {k: torch.as_tensor(v[None]).to(device)
              for k, v in patch.items()}

    def run():
        with torch.inference_mode():
            x, _ = fb.build_feature("type_encoder_input", groups)
            zt = model(x)
            px, _ = fb.build_feature("phase_ccdc", groups)
            zp = model.forward_phase(px, zt)
        return zt[0].float().cpu().numpy(), zp[0].float().cpu().numpy()

    kernel_zt, kernel_zp = run()
    spatial.bank_mix = sm.bank_mix_reference
    try:
        plain_zt, plain_zp = run()
    finally:
        spatial.bank_mix = sm.bank_mix
    res = {}
    for name, k, p, s in (("z_type", kernel_zt, plain_zt, served["z_type"]),
                          ("z_phase", kernel_zp, plain_zp,
                           served["z_phase"])):
        rel = float(np.abs(k - p).max() / max(np.abs(p).max(), 1e-12))
        res[name] = {"rel_err_vs_plain": rel,
                     "max_abs_err_served_vs_direct":
                         float(np.abs(s - k).max())}
        if not rel <= SERVE_REL_BOUND:
            raise AssertionError(f"{name}: kernel vs plain model rel err "
                                 f"{rel} > {SERVE_REL_BOUND}")
    log(f"served vs plain model: {json.dumps(res)} "
        f"(bound {SERVE_REL_BOUND})")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / KERNEL_SOURCE).is_file():
        print(f"chip_smoke: {KERNEL_SOURCE} not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import forest_tpu_torch
    if Path(forest_tpu_torch.__file__).resolve().parent != \
            ROOT / "forest_tpu_torch":
        print("chip_smoke: forest_tpu_torch resolves outside this checkout",
              file=sys.stderr)
        return 1
    from forest_tpu_torch.ops import _cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()                                        # phase 1
    log(card)

    t0 = time.perf_counter()                                  # phase 2
    _cuda_build.load_library("bank_mix_fwd")
    log(f"built bank_mix_fwd in {time.perf_counter() - t0:.2f} s")
    log(_cuda_build.build_info["bank_mix_fwd"]["log"].strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)    # phase 3
    f32 = check_kernel(SERVE_SHAPE, torch.float32, gen, timed=True)
    bf16 = check_kernel(SERVE_SHAPE, torch.bfloat16, gen, timed=True)
    for dt in (torch.float32, torch.bfloat16):
        check_kernel(ODD_SHAPE, dt, gen, timed=False)

    with tempfile.TemporaryDirectory() as d:                  # phase 4
        ckpt, bpath = write_checkpoint(Path(d))
        patches = make_patches(SERVE_SHAPE[0], SERVE_SHAPE[1])
        serve = serve_and_check(ckpt, bpath, patches)         # phase 5
        checked = serve.pop("checked")
        plain = check_against_plain(ckpt, bpath, patches[1],  # phase 6
                                    checked)
    log(f"serving: {json.dumps(serve)}")
    log(f"f32 kernel at {list(SERVE_SHAPE)}: {f32['ms']:.4f} ms, plain "
        f"{f32['plain_ms']:.4f} ms ({card})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "bank_mix_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": serve["launches"],
        "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"], "dtype": "bfloat16",
        "f32_ms": f32["ms"], "f32_plain_ms": f32["plain_ms"],
        "serve_rel_err_vs_plain": plain["z_type"]["rel_err_vs_plain"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
