"""Vector quantisation: nearest-code assignment, the two quantisers and the
EMA codebook state.

Port of ``forest_tpu/ops/vq.py``. A codebook of K vectors of dimension D;
rows of x are assigned to their nearest code under squared L2 with the
lowest index winning a tie. A NaN distance counts as +inf on every path: a
NaN input row lands on index 0, a NaN codebook row is never assigned.

- :func:`vq_core` is the fused pass of the quantisers: indices, quantised
  rows, per-code counts and sums, optionally ``sum(q * x)``. It is the
  wrapper of the hand-written CUDA kernel ``vq_core_f32`` in
  ``csrc/vq_assign.cu``; a CPU tensor goes to the plain version
  :func:`vq_core_reference`, a CUDA tensor launches the kernel or raises.
  ``vq_core.launches`` counts the launches. It is gradient-free: the
  straight-through estimator and the "st" codebook gradient live in
  :func:`quantize_st` / :func:`quantize_ema`, outside it.
- :func:`vq_assign` returns the indices only (``vq_assign_f32`` in the same
  source; plain version :func:`vq_assign_reference`); ``mxu_bf16=True``
  rounds both operands of the product to bfloat16 and keeps the sums, and
  ``||c||^2``, in float32.
- Both are ``torch.library`` ops, ``forest_tpu_torch::vq_core`` and
  ``::vq_assign``, whose FLOP formulas are their declared costs,
  :func:`vq_core_cost` and :func:`vq_assign_cost` (``utils/flops.py``).
- Every output of the kernels is reproducible from run to run: counts and
  sums are added in row order without float atomics (the EMA codebook feeds
  the next step's assignment).

The distances of the kernels drop the ``||x||^2`` term, which does not move
the argmin, and sum the products in another order than ``torch.matmul``: a
row whose two best codes lie within float32 rounding of each other may get
either index. ``chip_smoke.py`` holds the kernels to their plain versions
with a rule stated in float64.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from forest_tpu_torch.ops import _library
from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.parallel import dp
from forest_tpu_torch.utils.flops import KernelCost

_TILE_ROWS = 128            # rows of x per block in csrc/vq_tile.cuh
_SMALL_CODES = 16           # codes per block of the one-launch path
_SMALL_MAX_SLABS = 128      # its blocks, all resident at once
_RESIDENT_ROWS = 64         # rows per tile of the resident-codebook product
_SEGMENT_ROWS = 256         # rows per block of the statistics pass, at least
_MAX_SEGMENTS = 128
# The layout of the resident products' shared memory, as csrc/vq_resident.cuh
# states it (RES_ROWS, RES_CODES, MMA_STAGES, MMA_PAD; MAX_SHARED_BYTES less
# RES_STATIC_BYTES): tests/test_torch_vq.py holds these to the header.
_RESIDENT_CODES = 256       # codes per slab of the resident products
_SHARED_BYTES = 232448 - 4096  # dynamic shared memory a block may ask for
_MMA_STAGES = 3             # tiles of x in flight on the tensor-core path
_MMA_PAD = 8                # bfloat16 of padding per row of its tiles
#: vq_assign's paths, by the number csrc/vq_assign.cu takes
ASSIGN_PATHS = ("slab", "resident", "mma")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------------


def vq_distances(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [N, K] between x [N, D] and codebook [K, D],
    as ``||x||^2 - 2 x.C^T + ||C||^2`` in float32."""
    x = x.float()
    c = codebook.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 - 2.0 * (x @ c.t()) + c2[None, :]


def _sanitize_dist(d: torch.Tensor) -> torch.Tensor:
    """NaN distances -> +inf: a NaN input row becomes all-inf and its argmin
    0; a NaN codebook row NaNs only its column and is never assigned."""
    return torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)


def vq_core_reference(x: torch.Tensor, codebook: torch.Tensor,
                      with_qx: bool = False):
    """Plain version of :func:`vq_core`."""
    x = x.float()
    c = codebook.float()
    k = c.shape[0]
    d = _sanitize_dist(vq_distances(x, c))
    idx = torch.argmin(d, dim=-1)        # the first of equal minima
    q = c.index_select(0, idx)
    counts = torch.bincount(idx, minlength=k).float()
    sums = torch.zeros_like(c).index_add_(0, idx, x)
    idx = idx.to(torch.int32)
    if with_qx:
        return idx, q, counts, sums, torch.sum(q * x)
    return idx, q, counts, sums


def vq_assign_reference(x: torch.Tensor, codebook: torch.Tensor,
                        mxu_bf16: bool = False) -> torch.Tensor:
    """Plain version of :func:`vq_assign`."""
    if mxu_bf16:
        x32 = x.float()
        c32 = codebook.float()
        xc = x32.bfloat16().float() @ c32.bfloat16().float().t()
        d = (torch.sum(x32 * x32, -1, keepdim=True) - 2.0 * xc
             + torch.sum(c32 * c32, -1)[None, :])
    else:
        d = vq_distances(x, codebook)
    return torch.argmin(_sanitize_dist(d), dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, codebook: torch.Tensor) -> None:
    if x.dim() != 2 or codebook.dim() != 2 or \
            x.shape[1] != codebook.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be [N, D] and "
                         f"codebook {tuple(codebook.shape)} [K, D]")
    if codebook.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: empty codebook {tuple(codebook.shape)}")
    if x.device != codebook.device:
        raise ValueError(f"{name}: x on {x.device}, codebook on "
                         f"{codebook.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def stats_segments(n: int) -> Tuple[int, int]:
    """-> (S, rows per segment) of the statistics pass over n rows: whole
    tiles, at least ``_SEGMENT_ROWS`` rows each, at most ``_MAX_SEGMENTS``
    segments, together covering n."""
    seg = max(_SEGMENT_ROWS, -(-n // _MAX_SEGMENTS))
    seg = -(-seg // _TILE_ROWS) * _TILE_ROWS
    return max(1, -(-n // seg)), seg


def vq_core_small(n: int, k: int) -> bool:
    """Whether ``vq_core`` takes its one-launch path for n rows and k codes:
    n fits one row tile (the VQ-VAE step's 64 does) and the codebook's
    slabs of 16 codes are at most 128 blocks, all resident at once."""
    return n <= _TILE_ROWS and -(-k // _SMALL_CODES) <= _SMALL_MAX_SLABS


def resident_shared_bytes(d: int, k: int, transposed: bool = False) -> int:
    """Dynamic shared memory of the resident float32 product
    (``csrc/vq_resident.cuh``): the codebook in rows padded to 4 mod 32
    floats and two tiles of 64 rows of x (as [64, D] padded, or [D, 64])."""
    ld = d + (4 - d % 32 + 32) % 32
    kp = -(-k // _RESIDENT_CODES) * _RESIDENT_CODES
    tile = d * _RESIDENT_ROWS if transposed else _RESIDENT_ROWS * ld
    return 4 * (kp * ld + 2 * tile)


def mma_shared_bytes(d: int, k: int, transposed: bool = False,
                     esize: int = 4) -> int:
    """Dynamic shared memory of the tensor-core product: the codebook
    rounded to bfloat16 (depth padded to 16, plus 8), the rounded tile of x,
    ``_MMA_STAGES`` tiles of x as stored (``esize`` bytes an element) and
    the code norms."""
    dp = -(-d // 16) * 16
    kp = -(-k // _RESIDENT_CODES) * _RESIDENT_CODES
    xa = dp * (_RESIDENT_ROWS + _MMA_PAD) * 2 if transposed else \
        _RESIDENT_ROWS * (dp + _MMA_PAD) * 2
    return (kp * (dp + _MMA_PAD) * 2 + xa
            + _MMA_STAGES * _RESIDENT_ROWS * d * esize + 4 * kp)


@functools.lru_cache(maxsize=1024)
def vq_assign_path(n: int, d: int, k: int, mxu_bf16: bool = False,
                   aligned: bool = True) -> str:
    """Which product ``vq_assign`` runs for x [n, d] and k codes on a card:
    "resident" (float32 operands: the codebook resident in shared memory,
    the fmaf chains of ``vq_core``'s product, so the same indices), "mma"
    (``mxu_bf16``: bfloat16-rounded operands on the tensor cores), or
    "slab" (``csrc/vq_tile.cuh``'s tile) where d is no multiple of 4, a
    pointer is not 16-byte aligned (``aligned`` False) or the codebook does
    not fit shared memory. Every n >= 1 takes the same path."""
    del n
    if d % 4 or not aligned:
        return "slab"
    if mxu_bf16:
        return "mma" if mma_shared_bytes(d, k) <= _SHARED_BYTES else "slab"
    return "resident" if resident_shared_bytes(d, k) <= _SHARED_BYTES \
        else "slab"


def persistent_blocks(n: int, sms: int) -> int:
    """Blocks of one launch of the resident or tensor-core product over n
    rows (or columns) on a card of ``sms`` SMs: ``min(tiles of 64, sms)``.
    The C launch takes this count; any count >= 1 covers every tile."""
    return min(-(-n // _RESIDENT_ROWS), sms)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def assign_scratch(device: torch.device, k: int, d: int, path: str
                   ) -> Tuple[torch.Tensor, int, Optional[int]]:
    """-> (buffer, pointer to the code norms [k] float32, pointer to the
    codebook rounded to bfloat16 [k, d] or None): the scratch of one launch
    of an index-only kernel, in one buffer that the caller holds through the
    launch; the "mma" path needs the rounded codebook."""
    off = -(-k * 4 // 256) * 256
    size = off + (k * d * 2 if path == "mma" else 0)
    buf = torch.empty(size, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, base, (base + off if path == "mma" else None)


def vq_core_launches(n: int, k: int) -> int:
    """Kernel launches of one ``vq_core`` call on a card, n >= 1 rows."""
    return 1 if vq_core_small(n, k) else 4


@functools.lru_cache(maxsize=256)
def vq_core_scratch(n: int, d: int, k: int) -> Tuple[int, dict]:
    """-> (bytes, {name: (byte offset, elements)}) of the one scratch
    buffer of ``vq_core`` at n >= 1 rows: on the one-launch path the slabs'
    best (distance, index) per row (``part_d``, ``part_i``: 16 codes a
    slab) and the slabs' partials of sum(q * x) (``qx_part``); otherwise
    the code norms ``c2``, the segments' counts and sums (``cnt_part``
    [S, K], ``sum_part`` [S, K, D]) and the partials of sum(q * x)
    (``qx_part``, one per block of the product: at most one per 64 rows).
    Every part starts on 256 bytes."""
    if vq_core_small(n, k):
        slabs = -(-k // _SMALL_CODES)
        parts = (("part_d", slabs * n), ("part_i", slabs * n),
                 ("qx_part", slabs))
    else:
        segs, _ = stats_segments(n)
        parts = (("c2", k), ("cnt_part", segs * k),
                 ("sum_part", segs * k * d),
                 ("qx_part", -(-n // _RESIDENT_ROWS)))
    layout, off = {}, 0
    for name, count in parts:
        layout[name] = (off, count)
        off += -(-count * 4 // 256) * 256
    return off, layout


@functools.lru_cache(maxsize=None)
def _core_fn():
    """``vq_core_f32``, typed once per process."""
    fn = load_library("vq_assign").vq_core_f32
    fn.argtypes = ([ctypes.c_void_p] * 14
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _assign_fn():
    """``vq_assign_f32``, typed once per process."""
    fn = load_library("vq_assign").vq_assign_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_barriers = {}   # (device, stream) -> the one-launch path's grid barrier


def _barrier(dev: torch.device, stream: int) -> torch.Tensor:
    """Two zeroed int32 for the one-launch path's grid barrier on
    ``stream`` (arrivals, generation); the kernel leaves the arrivals at 0,
    so they are made once."""
    key = (dev, stream)
    t = _barriers.get(key)
    if t is None:
        t = _barriers[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return t


def vq_core_cost(n: int, d: int, k: int, with_qx: bool = False
                 ) -> KernelCost:
    """One call of ``vq_core`` on x [n, d] and k codes: the distances'
    product, 2 n k d FLOPs, and with ``with_qx`` sum(q * x), 2 n d (the
    statistics' n d adds and ``||c||^2``'s 2 k d are left out, as the
    kernels' bound has always counted them); x, the codebook and the outputs
    (idx int32, q, counts, sums, and sum(q * x)) in float32, each once.

    The Pallas estimate (``forest_tpu/ops/vq.py:213``) counts 4 n k d over
    padded tiles: the TPU kernel forms q and the sums as one-hot products,
    where this kernel gathers and adds."""
    return KernelCost(
        flops=2 * n * k * d + (2 * n * d if with_qx else 0),
        bytes_accessed=4 * (2 * n * d + 2 * k * d + n + k
                            + (1 if with_qx else 0)))


def vq_assign_cost(n: int, d: int, k: int, mxu_bf16: bool = False
                   ) -> KernelCost:
    """One call of ``vq_assign`` on x [n, d] and k codes: the distances'
    product, 2 n k d FLOPs; x and the codebook read once in float32 and the
    int32 indices written once. ``mxu_bf16`` changes neither (the kernel
    rounds the float32 operands in registers): it moves the product onto the
    tensor cores, whose peak a bound reads it against.

    The Pallas estimate (``forest_tpu/ops/vq.py:292``) is the same formula
    over tiles padded to 128 rows and codes."""
    del mxu_bf16
    return KernelCost(flops=2 * n * k * d,
                      bytes_accessed=4 * (n * d + k * d + n))


def _plain_core(x, codebook, with_qx):
    out = vq_core_reference(x, codebook, with_qx)
    return out if with_qx else (*out, torch.zeros(()))


def _launch_core(x, codebook, with_qx):
    """``vq_core_f32`` on the current stream: -> (idx, q, counts, sums,
    sum(q * x)); the last is left unset where ``with_qx`` is false (the
    kernel does not write it, and :func:`vq_core` drops it)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    if codebook.dtype != torch.float32 or not codebook.is_contiguous():
        codebook = codebook.float().contiguous()
    c = codebook
    n, d = x.shape
    k = c.shape[0]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, d, **f32), torch.zeros(k, **f32),
                torch.zeros(k, d, **f32), torch.zeros((), **f32))
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch_core(x, c, with_qx)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    q, counts = torch.empty(n, d, **f32), torch.empty(k, **f32)
    sums = torch.empty(k, d, **f32)
    qx = torch.empty((), **f32)
    nbytes, layout = vq_core_scratch(n, d, k)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    sbase = scratch.data_ptr()
    ptr = {name: sbase + off for name, (off, _) in layout.items()}
    small = vq_core_small(n, k)
    segs, seg_rows = (1, n) if small else stats_segments(n)
    stream = torch.cuda.current_stream().cuda_stream
    err = _core_fn()(
        x.data_ptr(), c.data_ptr(), idx.data_ptr(), q.data_ptr(),
        counts.data_ptr(), sums.data_ptr(), qx.data_ptr(), ptr.get("part_d"),
        ptr.get("part_i"),
        _barrier(dev, stream).data_ptr() if small else None,
        ptr.get("c2"), ptr.get("cnt_part"), ptr.get("sum_part"),
        ptr["qx_part"], n, d, k, segs, seg_rows, int(bool(with_qx)), stream)
    if err != 0:
        raise RuntimeError(f"vq_core launch failed: cudaError {err} "
                           f"(N={n}, D={d}, K={k})")
    vq_core.launches += 1
    return idx, q, counts, sums, qx


def _fake_core(x, codebook, with_qx):
    n, d = x.shape
    k = codebook.shape[0]
    f32 = dict(dtype=torch.float32)
    return (x.new_empty(n, dtype=torch.int32), x.new_empty(n, d, **f32),
            x.new_empty(k, **f32), x.new_empty(k, d, **f32),
            x.new_empty((), **f32))


_library.define(
    "vq_core", "(Tensor x, Tensor codebook, bool with_qx) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)", cpu=_plain_core,
    cuda=_launch_core, fake=_fake_core,
    flops=lambda x, c, with_qx, out_shape=None: vq_core_cost(
        *x, c[0], with_qx).flops)


def vq_core(x: torch.Tensor, codebook: torch.Tensor, with_qx: bool = False):
    """-> (idx [N] int32, q [N, D], counts [K], sums [K, D]) in float32, and
    ``sum(q * x)`` as a fifth value with ``with_qx``. Gradient-free: callers
    detach the inputs. The op ``forest_tpu_torch::vq_core``; on a card the
    kernels' scratch is one buffer (:func:`vq_core_scratch`), and at N up to
    128 rows (and K up to 2,048) the call is one launch
    (:func:`vq_core_small`)."""
    _check("vq_core", x, codebook)
    out = torch.ops.forest_tpu_torch.vq_core(x, codebook, with_qx)
    return out if with_qx else out[:4]


vq_core.launches = 0


def _launch_assign(x, codebook, mxu_bf16):
    """``vq_assign_f32`` on the current stream, by :func:`vq_assign_path`."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    c = codebook
    if c.dtype != torch.float32 or not c.is_contiguous():
        c = c.float().contiguous()
    n, d = x.shape
    k = c.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return idx
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch_assign(x, c, mxu_bf16)
    xp, cp = x.data_ptr(), c.data_ptr()
    path = vq_assign_path(n, d, k, mxu_bf16, (xp | cp) % 16 == 0)
    scratch, c2, cb16 = assign_scratch(x.device, k, d, path)
    err = _assign_fn()(
        xp, cp, c2, cb16, idx.data_ptr(), n, d, k, int(mxu_bf16),
        ASSIGN_PATHS.index(path),
        persistent_blocks(n, sm_count(x.device.index)),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_assign launch failed: cudaError {err} "
                           f"(N={n}, D={d}, K={k}, path {path})")
    vq_assign.launches += 1
    vq_assign.last_path = path
    return idx


_library.define(
    "vq_assign", "(Tensor x, Tensor codebook, bool mxu_bf16) -> Tensor",
    cpu=vq_assign_reference, cuda=_launch_assign,
    fake=lambda x, codebook, mxu_bf16: x.new_empty(x.shape[0],
                                                   dtype=torch.int32),
    flops=lambda x, c, mxu_bf16, out_shape=None: vq_assign_cost(
        *x, c[0], mxu_bf16).flops)


def vq_assign(x: torch.Tensor, codebook: torch.Tensor, **kw) -> torch.Tensor:
    """Nearest-code indices [N] (int32), lowest index on ties; float32 by
    default, bit-consistent with :func:`vq_core`'s assignments.
    ``mxu_bf16=True`` rounds the product's operands to bfloat16 (near-ties
    may flip), on the tensor cores of a card. The op
    ``forest_tpu_torch::vq_assign``. :func:`vq_assign_path` says which
    product a call runs; ``vq_assign.last_path`` is the last one a launch
    took."""
    known = {"mxu_bf16"}
    bad = set(kw) - known
    if bad:
        raise TypeError(f"vq_assign got unexpected kwargs {sorted(bad)}; "
                        f"accepted: {sorted(known)}")
    _check("vq_assign", x, codebook)
    return torch.ops.forest_tpu_torch.vq_assign(
        x, codebook, bool(kw.get("mxu_bf16", False)))


vq_assign.launches = 0
vq_assign.last_path = None


# ---------------------------------------------------------------------------
# quantiser variants (gradient semantics)
# ---------------------------------------------------------------------------


class VQResult(NamedTuple):
    quantized: torch.Tensor   # [N, D] straight-through output
    indices: torch.Tensor     # [N] int32
    vq_loss: torch.Tensor     # scalar
    counts: torch.Tensor      # [K] per-code counts of this batch
    sums: torch.Tensor        # [K, D] per-code sums of this batch
    perplexity: torch.Tensor  # scalar exp(entropy) of the code distribution


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def perplexity_from_counts(counts: torch.Tensor) -> torch.Tensor:
    p = counts / torch.clamp(torch.sum(counts), min=1.0)
    plogp = torch.where(p > 0, p * torch.log(torch.where(p > 0, p,
                                                         torch.ones_like(p))),
                        torch.zeros_like(p))
    return torch.exp(-torch.sum(plogp))


def quantize_st(x: torch.Tensor, codebook: torch.Tensor,
                beta: float = 0.25) -> VQResult:
    """Straight-through quantiser: the codebook learns by gradient, through
    a one-hot product outside the kernel.
    vq_loss = ||sg(x) - q||^2 + beta * ||x - sg(q)||^2."""
    idx, _, counts, sums = vq_core(x.detach(), codebook.detach())
    onehot = F.one_hot(idx.long(), codebook.shape[0]).to(x.dtype)
    q = (onehot @ codebook.to(x.dtype)).to(x.dtype)
    codebook_loss = torch.mean(torch.sum((x.detach() - q) ** 2, dim=-1))
    commit_loss = torch.mean(torch.sum((x - q.detach()) ** 2, dim=-1))
    vq_loss = codebook_loss + beta * commit_loss
    return VQResult(_ste(x, q), idx, vq_loss, counts, sums,
                    perplexity_from_counts(counts))


def quantize_ema(x: torch.Tensor, codebook: torch.Tensor,
                 beta: float = 0.25) -> VQResult:
    """EMA quantiser: the codebook is updated by
    :func:`ema_codebook_update`, not by gradient.
    vq_loss = beta * ||x - sg(q)||^2."""
    idx, q, counts, sums = vq_core(x.detach(), codebook.detach())
    q = q.to(x.dtype)
    commit_loss = torch.mean(torch.sum((x - q) ** 2, dim=-1))
    return VQResult(_ste(x, q), idx, beta * commit_loss, counts, sums,
                    perplexity_from_counts(counts))


def quantize(x: torch.Tensor, codebook: torch.Tensor, mode: str = "ema",
             beta: float = 0.25) -> VQResult:
    if mode == "st":
        return quantize_st(x, codebook, beta)
    if mode == "ema":
        return quantize_ema(x, codebook, beta)
    raise ValueError(f"unknown quantizer mode {mode!r} (expected 'st'|'ema')")


# ---------------------------------------------------------------------------
# EMA codebook state
# ---------------------------------------------------------------------------


class VQStats(NamedTuple):
    """EMA state and cumulative usage."""
    cluster_size: torch.Tensor   # [K] EMA of per-code counts
    cluster_sum: torch.Tensor    # [K, D] EMA of per-code sums
    code_usage: torch.Tensor     # [K] cumulative assignment counts

    @staticmethod
    def init(num_codes: int, code_dim: int, dtype=torch.float32,
             codebook: Optional[torch.Tensor] = None,
             device=None) -> "VQStats":
        """With ``codebook`` (the training path): cluster_size 1 and
        cluster_sum a copy of the codebook, so a code that is never assigned
        keeps exactly its initial vector (size and sum decay at the same
        rate) instead of collapsing to zero on the first update. The copy
        never aliases the parameter. Without it, zeros."""
        if codebook is not None:
            device = codebook.device if device is None else device
            return VQStats(
                torch.ones(num_codes, dtype=dtype, device=device),
                codebook.detach().to(device=device, dtype=dtype, copy=True),
                torch.zeros(num_codes, dtype=dtype, device=device))
        return VQStats(torch.zeros(num_codes, dtype=dtype, device=device),
                       torch.zeros(num_codes, code_dim, dtype=dtype,
                                   device=device),
                       torch.zeros(num_codes, dtype=dtype, device=device))


@torch.no_grad()
def ema_codebook_update(stats: VQStats, codebook: torch.Tensor,
                        counts: torch.Tensor, sums: torch.Tensor,
                        decay: float = 0.99, eps: float = 1e-5,
                        group=None) -> Tuple[VQStats, torch.Tensor]:
    """Fold one batch's counts and sums into the EMA codebook; Laplace
    smoothing keeps dead codes numerically alive. -> (stats, codebook),
    both new tensors. With ``group`` (a ``torch.distributed`` process
    group, one rank per replica), counts and sums are first summed across
    its ranks in one all-reduce, so every rank applies the same global
    update (the JAX package's ``psum`` over ``axis_name``)."""
    if group is not None:
        counts, sums = dp.all_reduce_sum([counts, sums], group)
    k = stats.cluster_size.shape[0]
    new_size = decay * stats.cluster_size + (1.0 - decay) * counts
    new_sum = decay * stats.cluster_sum + (1.0 - decay) * sums
    n = torch.sum(new_size)
    smoothed = (new_size + eps) / (n + k * eps) * n
    new_codebook = new_sum / smoothed[:, None]
    new_stats = VQStats(new_size, new_sum, stats.code_usage + counts)
    return new_stats, new_codebook.to(codebook.dtype)


@torch.no_grad()
def reseed_dead_codes(codebook: torch.Tensor, stats: VQStats,
                      candidates: torch.Tensor,
                      pick: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      threshold: float = 1e-3
                      ) -> Tuple[torch.Tensor, VQStats]:
    """Replace codes whose EMA cluster size fell below ``threshold`` with
    rows of ``candidates`` (encoder outputs of the batch). ``pick`` [K] are
    the candidate rows, one per code; left out, they are drawn uniformly
    from ``generator``."""
    k = codebook.shape[0]
    dead = stats.cluster_size < threshold
    if pick is None:
        gen_dev = generator.device if generator is not None else "cpu"
        pick = torch.randint(0, candidates.shape[0], (k,),
                             generator=generator, device=gen_dev)
    fresh = candidates.detach()[pick.to(candidates.device).long()].to(
        codebook.dtype)
    new_cb = torch.where(dead[:, None], fresh, codebook)
    mean_size = torch.clamp(torch.mean(stats.cluster_size), min=1.0)
    new_stats = VQStats(
        torch.where(dead, mean_size, stats.cluster_size),
        torch.where(dead[:, None], fresh * mean_size, stats.cluster_sum),
        stats.code_usage)
    return new_cb, new_stats


__all__ = [
    "VQResult", "VQStats", "vq_core", "vq_assign", "vq_core_reference",
    "vq_assign_reference", "vq_distances", "quantize", "quantize_st",
    "quantize_ema", "ema_codebook_update", "reseed_dead_codes",
    "perplexity_from_counts", "stats_segments", "vq_core_small",
    "vq_core_launches", "vq_core_scratch", "vq_assign_path",
    "persistent_blocks", "sm_count",
    "resident_shared_bytes", "mma_shared_bytes", "ASSIGN_PATHS",
    "assign_scratch", "vq_core_cost", "vq_assign_cost",
]
