"""Variant sweep of the VQ assignment kernel.

Port of ``scripts/bench_vq_variants.py``: the index-only assignment with the
knobs whose cost the sweep separates (precision of the product's operands,
rows per block, storage type of x and the codebook, the argmin itself, and
the layout of x), and the sweep that times them.

- :func:`make_assign` builds ``assign(x [N, D], codebook) -> idx [N]`` over
  the kernel ``vq_variant_rows`` of ``csrc/vq_variants.cu``;
- :func:`make_assign_t` the same over ``vq_variant_cols``, which reads x as
  [D, N] (given so with ``pre_transposed``, else transposed first).

On a card both run the products of ``csrc/vq_resident.cuh`` in
:func:`launch_grid` persistent blocks (:func:`rows_path` / :func:`cols_path`
say which): float32 operands the resident fmaf chains of
``ops.vq.vq_assign``, rounded operands its tensor-core product.

A CPU tensor goes to the plain versions :func:`assign_reference` /
:func:`assign_t_reference`; a CUDA tensor launches the kernel or raises.
``make_assign.launches`` / ``make_assign_t.launches`` count the launches of
all the functions they built. Unlike ``ops.vq``, these have no NaN rule.
:func:`assign_cost` states one call's work (``utils/flops.py``'s
``KernelCost``) for the kernels' bound; the sweep's kernels are not ops.

    python -m forest_tpu_torch.ops.vq_variants [--iters 20]

prints microseconds per call of every variant at N 131072, D 128, K 256 on
the card, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import sys
from typing import Callable, Dict

import torch

from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.ops.vq import (ASSIGN_PATHS, _SHARED_BYTES,
                                     assign_scratch, mma_shared_bytes,
                                     persistent_blocks,
                                     resident_shared_bytes, sm_count)
from forest_tpu_torch.utils.flops import KernelCost

N, D, K = 128 * 1024, 128, 256
ITERS = 20
_TILE_ROWS = 128            # rows of x per pass in csrc/vq_tile.cuh


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _distances(xf: torch.Tensor, cf: torch.Tensor,
               mxu_bf16: bool) -> torch.Tensor:
    """``||c||^2 - 2 x.c^T`` [N, K] in float32 from x [N, D] and c [K, D] as
    stored (float32 or bfloat16); ``||c||^2`` from the stored c."""
    c2 = torch.sum(cf.float() ** 2, dim=-1)[None, :]
    if mxu_bf16:
        xf, cf = xf.bfloat16(), cf.bfloat16()
    return c2 - 2.0 * (xf.float() @ cf.float().t())


def assign_reference(x: torch.Tensor, cb: torch.Tensor,
                     mxu_bf16: bool = False,
                     io_dtype: torch.dtype = torch.float32,
                     argmin: bool = True) -> torch.Tensor:
    """Plain version of :func:`make_assign`'s function."""
    dist = _distances(x.to(io_dtype), cb.to(io_dtype), mxu_bf16)
    if argmin:
        return torch.argmin(dist, dim=1).to(torch.int32)
    return torch.min(dist, dim=1).values.to(torch.int32)


def assign_t_reference(x: torch.Tensor, cb: torch.Tensor,
                       mxu_bf16: bool = False,
                       io_dtype: torch.dtype = torch.float32,
                       pre_transposed: bool = False) -> torch.Tensor:
    """Plain version of :func:`make_assign_t`'s function."""
    xt = (x if pre_transposed else x.t()).to(io_dtype)
    dist = _distances(xt.t(), cb.to(io_dtype), mxu_bf16)
    return torch.argmin(dist, dim=1).to(torch.int32)


def matmul_assign(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """The sweep's yardstick: the full squared distance with PyTorch's own
    product, then its argmin."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(cb * cb, dim=-1)
    d = x2 - 2.0 * (x @ cb.t()) + c2[None, :]
    return torch.argmin(d, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, tile: int, io_dtype: torch.dtype, x: torch.Tensor,
           cb: torch.Tensor, d_axis: int) -> None:
    if io_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: io_dtype {io_dtype} (float32 or bfloat16)")
    if tile < _TILE_ROWS or tile % _TILE_ROWS:
        raise ValueError(f"{name}: tile {tile} must be a positive multiple "
                         f"of {_TILE_ROWS}")
    if x.dim() != 2 or cb.dim() != 2 or x.shape[d_axis] != cb.shape[1] \
            or cb.shape[0] < 1 or cb.shape[1] < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} and codebook "
                         f"{tuple(cb.shape)} do not fit")
    if x.device != cb.device:
        raise ValueError(f"{name}: x on {x.device}, codebook on {cb.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _persistent_path(d: int, k: int, transposed: bool, mxu_bf16: bool,
                     esize: int) -> str:
    if mxu_bf16 or esize == 2:
        ok = mma_shared_bytes(d, k, transposed, esize) <= _SHARED_BYTES
        return "mma" if ok else "slab"
    return "resident" if resident_shared_bytes(d, k, transposed) \
        <= _SHARED_BYTES else "slab"


@functools.lru_cache(maxsize=1024)
def rows_path(n: int, d: int, k: int, mxu_bf16: bool = False,
              io_dtype: torch.dtype = torch.float32,
              aligned: bool = True) -> str:
    """Which product ``make_assign``'s kernel runs on x [n, d] and k codes:
    "resident" (float32 operands: ``ops.vq.vq_assign``'s float32 product,
    the same fmaf chains), "mma" (operands rounded to bfloat16, by
    ``mxu_bf16`` or by bfloat16 storage: the tensor cores), or "slab"
    (``csrc/vq_tile.cuh``'s tile, one block per 128 rows) where d is no
    multiple of 4 (of 8 in bfloat16: a row must be whole 16-byte pieces),
    a pointer is not on 16 bytes (``aligned``) or the codebook does not fit
    shared memory. Every n >= 1 takes the same path; the TPU's ``tile`` has
    no say."""
    del n
    esize = 2 if io_dtype == torch.bfloat16 else 4
    if d % 4 or d % (16 // esize) or not aligned:
        return "slab"
    return _persistent_path(d, k, False, mxu_bf16, esize)


@functools.lru_cache(maxsize=1024)
def cols_path(n: int, d: int, k: int, mxu_bf16: bool = False,
              io_dtype: torch.dtype = torch.float32,
              aligned: bool = True) -> str:
    """Which product ``make_assign_t``'s kernel runs on x [d, n] and k codes:
    "resident" (float32 operands: the fmaf chains of ``ops.vq``'s resident
    product, in the same order), "mma" (operands rounded to bfloat16, by
    ``mxu_bf16`` or by bfloat16 storage: the tensor cores), or "slab"
    (``csrc/vq_tile.cuh``'s tile, one block per 128 columns) where d is no
    multiple of 4, a row of [d, n] does not start on 16 bytes (n a multiple
    of 4 in float32, 8 in bfloat16; ``aligned`` for the pointers) or the
    codebook does not fit shared memory. The TPU's ``tile`` has no say."""
    esize = 2 if io_dtype == torch.bfloat16 else 4
    if d % 4 or n % (16 // esize) or not aligned:
        return "slab"
    return _persistent_path(d, k, True, mxu_bf16, esize)


def launch_grid(n: int, sms: int) -> int:
    """Blocks of one ``make_assign`` / ``make_assign_t`` launch over n rows
    (columns) on a card of ``sms`` SMs on the "resident" and "mma" paths,
    the count the launch takes: ``min(tiles of 64, sms)`` persistent blocks,
    never a function of the TPU's ``tile``. (The "slab" path runs one block
    per 128.)"""
    return persistent_blocks(n, sms)


def assign_cost(n: int, d: int, k: int) -> KernelCost:
    """One call of a function of :func:`make_assign` or
    :func:`make_assign_t` on x of n rows of d and k codes: the distances'
    product, 2 n k d FLOPs; x and the codebook read once in float32 and
    the int32 output written once. Neither the layout of x nor the TPU's
    tile changes it. The TPU sweep's kernels state no estimate."""
    return KernelCost(flops=2 * n * k * d,
                      bytes_accessed=4 * (n * d + k * d) + 4 * n)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """``vq_variant_rows`` / ``vq_variant_cols``, typed once per process:
    pointers (x, codebook, scratch, rounded codebook, out), N, D, K, tile,
    is_bf16, mxu_bf16, [``argmin``,] path, blocks, the stream."""
    fn = getattr(load_library("vq_variants"), name)
    rows = name == "vq_variant_rows"
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * (8 if rows else 7) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, counter: Callable, xf: torch.Tensor,
            cf: torch.Tensor, n: int, tile: int, mxu_bf16: bool, path: str,
            argmin: bool = True) -> torch.Tensor:
    """One launch of ``entry`` on xf ([N, D] or [D, N]) and cf [K, D], both
    contiguous and of one storage type, on ``path`` with
    :func:`launch_grid`'s block count; ``argmin`` only for the rows."""
    k, d = cf.shape
    out = torch.empty(n, dtype=torch.int32, device=xf.device)
    if n == 0:
        return out
    if xf.device.index != torch.cuda.current_device():
        with torch.cuda.device(xf.device):
            return _launch(entry, counter, xf, cf, n, tile, mxu_bf16, path,
                           argmin)
    rows = entry == "vq_variant_rows"
    scratch, c2, cb16 = assign_scratch(xf.device, k, d, path)
    err = _entry(entry)(
        xf.data_ptr(), cf.data_ptr(), c2, cb16, out.data_ptr(), n, d, k,
        tile, int(xf.dtype == torch.bfloat16), int(mxu_bf16),
        *((int(argmin),) if rows else ()), ASSIGN_PATHS.index(path),
        launch_grid(n, sm_count(xf.device.index)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err} "
                           f"(N={n}, D={d}, K={k}, tile={tile})")
    counter.launches += 1
    return out


def make_assign(tile_n: int, mxu_bf16: bool,
                io_dtype: torch.dtype = torch.float32,
                argmin: bool = True) -> Callable:
    """-> assign(x [N, D], cb [K, D]) -> [N] int32: the index of the nearest
    code (lowest on ties) or, with ``argmin=False``, the smallest distance
    ``||c||^2 - 2 x.c`` converted to int32 by truncation. x and cb are cast
    to ``io_dtype`` before the kernel. ``tile_n`` is the TPU kernel's rows
    per grid step: checked (a positive multiple of 128) and named in the
    sweep, but the card's launch does not follow it: :func:`launch_grid`
    persistent blocks walk tiles of 64 rows on the product :func:`rows_path`
    picks. ``make_assign.last_path`` is the path of the last launch."""
    def assign(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        _check("make_assign", tile_n, io_dtype, x, cb, 1)
        if x.device.type == "cpu":
            return assign_reference(x, cb, mxu_bf16, io_dtype, argmin)
        xf = x.detach().to(io_dtype).contiguous()
        cf = cb.detach().to(io_dtype).contiguous()
        path = rows_path(xf.shape[0], xf.shape[1], cf.shape[0], mxu_bf16,
                         io_dtype, aligned=(xf.data_ptr() % 16 == 0
                                            and cf.data_ptr() % 16 == 0))
        out = _launch("vq_variant_rows", make_assign, xf, cf, x.shape[0],
                      tile_n, mxu_bf16, path, argmin)
        make_assign.last_path = path
        return out
    return assign


make_assign.launches = 0
make_assign.last_path = None


def make_assign_t(tile_t: int, mxu_bf16: bool,
                  io_dtype: torch.dtype = torch.float32,
                  pre_transposed: bool = False) -> Callable:
    """-> assign(x, cb [K, D]) -> idx [N] int32, with x [D, N] when
    ``pre_transposed`` and [N, D] (transposed before the kernel) otherwise.
    ``tile_t`` is the TPU kernel's grid step over the columns: it is checked
    (a positive multiple of 128) and named in the sweep, but the card's
    launch does not follow it: :func:`launch_grid` persistent blocks walk
    tiles of 64 columns, on the product :func:`cols_path` picks, so every
    ``tile_t`` gives the same indices. ``make_assign_t.last_path`` is the
    path of the last launch."""
    def assign(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        _check("make_assign_t", tile_t, io_dtype, x, cb,
               0 if pre_transposed else 1)
        if x.device.type == "cpu":
            return assign_t_reference(x, cb, mxu_bf16, io_dtype,
                                      pre_transposed)
        xt = (x if pre_transposed else x.t()).detach().to(
            io_dtype).contiguous()
        cf = cb.detach().to(io_dtype).contiguous()
        path = cols_path(xt.shape[1], xt.shape[0], cf.shape[0], mxu_bf16,
                         io_dtype, aligned=(xt.data_ptr() % 16 == 0
                                            and cf.data_ptr() % 16 == 0))
        out = _launch("vq_variant_cols", make_assign_t, xt, cf, xt.shape[1],
                      tile_t, mxu_bf16, path)
        make_assign_t.last_path = path
        return out
    return assign


make_assign_t.launches = 0
make_assign_t.last_path = None


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timeit(name: str, fn: Callable, x: torch.Tensor, cb: torch.Tensor,
           iters: int = ITERS) -> float:
    """Microseconds per call: CUDA events around ``iters`` calls, after one
    warm call."""
    fn(x, cb)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x, cb)
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) / iters * 1e3
    log(f"{name:42s} {us:9.1f} us/call")
    return us


def variants(x: torch.Tensor, xt: torch.Tensor):
    """(name, function, its x) for every variant of the sweep."""
    f32, bf16 = torch.float32, torch.bfloat16
    yield "torch (matmul + argmin)", matmul_assign, x
    for tile in (512, 1024, 2048, 4096):
        yield (f"kernelT bf16-mxu tileT={tile} (incl x.T)",
               make_assign_t(tile, True, f32, False), x)
        yield (f"kernelT bf16-mxu tileT={tile} (pre-T)",
               make_assign_t(tile, True, f32, True), xt)
        yield (f"kernelT f32     tileT={tile} (pre-T)",
               make_assign_t(tile, False, f32, True), xt)
    yield ("kernelT bf16-io tileT=2048 (pre-T)",
           make_assign_t(2048, True, bf16, True), xt)
    yield ("kernel row-major f32 tile=512 (ref)",
           make_assign(512, False, f32), x)


def main(argv=None, device: str = "cuda") -> Dict[str, float]:
    """Run the sweep on the card; -> {variant name: microseconds per call}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times CUDA kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(N, D, device=device, generator=gen)
    cb0 = torch.randn(K, D, device=device, generator=gen)
    log(f"card={card_line()} N={N} D={D} K={K} iters={args.iters}")

    got = make_assign_t(512, False, torch.float32, False)(x, cb0)
    exp = matmul_assign(x, cb0)
    log(f"kernelT f32 mismatch vs torch: "
        f"{(got != exp).float().mean().item():.6f}")

    xt = x.t().contiguous()
    times = {name: timeit(name, fn, xin, cb0, args.iters)
             for name, fn, xin in variants(x, xt)}
    print(f"{card_line()}: " + "; ".join(
        f"{name} {us:.1f} us" for name, us in times.items()), flush=True)
    return times


__all__ = ["make_assign", "make_assign_t", "rows_path", "cols_path",
           "launch_grid", "assign_cost",
           "assign_reference",
           "assign_t_reference", "matmul_assign", "timeit", "variants", "main",
           "N", "D", "K"]


if __name__ == "__main__":
    main()
