"""Directional filter bank + rank-R mixing for EdgeAwareSmoothingConv2D.

Port of ``forest_tpu/ops/smoothing.py``. Layout is channel-last NHWC, as in
the JAX package:

- :func:`sobel_grads` and :func:`depthwise_bank_conv` are grouped
  ``F.conv2d`` calls (the fixed Sobel pair and 3-tap direction templates);
- :func:`bank_mix_reference` is the plain PyTorch version of
  ``bank_mix_xla``: both banks as grouped convs, then the per-pixel einsum;
- :func:`bank_mix` is the wrapper of the hand-written CUDA kernels
  ``csrc/bank_mix_fwd.cu`` and, for the gradient, ``csrc/bank_mix_bwd.cu``
  (:func:`bank_mix_bwd`). Each is a ``torch.library`` op,
  ``forest_tpu_torch::bank_mix_fwd`` and ``::bank_mix_bwd``, the second the
  first's registered gradient: a CPU tensor goes to the plain versions
  (:func:`bank_mix_bwd_reference` writes the gradient out), a CUDA tensor
  launches the kernels or raises. ``bank_mix.launches`` and
  ``bank_mix_bwd.launches`` count the launches. Each op's FLOP formula is
  its declared cost, :func:`bank_mix_cost` / :func:`bank_mix_bwd_cost`
  (``utils/flops.py``).

The forward is one kernel and one pass: a block walks down a strip of 32
pixel columns, keeps a ring of 2 dc + 2 rows of x in shared memory (filled
one row ahead with ``cp.async``), reads A and B of a row once with 16-byte
loads straight into registers (eight lanes a pixel, channel pairs) and
stores each output once. It refuses (``RuntimeError`` naming the limit) a
shape of which one pixel column with its halo does not fit a block:
``(2 dc + 2) * (1 + 2 dc) * pad(C) * itemsize`` above 232,448 bytes of
shared memory (:func:`fwd_min_shared_bytes`).

The backward is one kernel and one pass: a block walks down a strip of
pixel columns, reads g, A and B of a row once into registers, stages that
row's products g * M_k and a ring of 2 dc + 2 rows of x in shared memory,
and writes dx, dA and dB together, dx through a ring of 2 dc + 1 rows of
accumulators in shared memory; no atomics, float32 accumulation, one
rounding at each store. Its bound is its bytes (every tensor once: 0.56 ms
in float32, 0.28 ms in bfloat16 at [12, 256, 256, 48] on an H100 at 3.35
TB/s). Both kernels have three paths, chosen in the C function from the
shape: R = 4, K = 8 and C = 48 (the shipped model's width, compiled in),
the same with any other even C, and a scalar path for every other R, K and
C. The backward refuses (``RuntimeError`` naming the limit) a shape of
which one pixel column with its halo does not fit a block:
``coarse_dilation`` above 19, or
``(1 + 2 dc) * 4 * (pad(K C) + (4 dc + 3) pad(C))`` above 232,448
bytes of shared memory, ``pad(n)`` being n rounded up to 8 modulo 16, or
to 16 modulo 32 where R = 4, K = 8 and C is even (C up to about 1,000 at
K = 8 and dc = 3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from forest_tpu_torch.ops import _library
from forest_tpu_torch.ops._cuda_build import load_library
from forest_tpu_torch.utils.flops import KernelCost

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _direction_bank() -> np.ndarray:
    """[4, 3, 3] fixed orientation templates (3-tap means)."""
    t = np.zeros((4, 3, 3), np.float32)
    t[0, 1, :] = 1 / 3
    t[1, :, 1] = 1 / 3
    t[2, [0, 1, 2], [0, 1, 2]] = 1 / 3
    t[3, [0, 1, 2], [2, 1, 0]] = 1 / 3
    return t


def _sobel() -> Tuple[np.ndarray, np.ndarray]:
    sx = np.array([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                  np.float32) / 4.0
    sy = np.array([[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]],
                  np.float32) / 4.0
    return sx, sy


def _grouped_conv_nhwc(x: torch.Tensor, templates: np.ndarray,
                       dilation: int) -> torch.Tensor:
    """Apply F fixed [3,3] templates to every channel of NHWC ``x``.

    Returns [B, H, W, C*F] with output channel ``c*F + f`` = template f on
    channel c (zero padding, cross-correlation as ``lax.conv``)."""
    c = x.shape[-1]
    f = templates.shape[0]
    w = torch.as_tensor(np.tile(templates[None], (c, 1, 1, 1)),
                        dtype=x.dtype, device=x.device)
    w = w.reshape(c * f, 1, 3, 3)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=dilation,
                   dilation=dilation, groups=c)
    return out.permute(0, 2, 3, 1)


def depthwise_bank_conv(x: torch.Tensor, bank: np.ndarray,
                        dilation: int = 1) -> torch.Tensor:
    """x [B, H, W, C]; bank [F, 3, 3] -> [B, H, W, C, F]."""
    b, h, w, c = x.shape
    bank = np.asarray(bank, np.float32)
    return _grouped_conv_nhwc(x, bank, dilation).reshape(
        b, h, w, c, bank.shape[0])


def sobel_grads(x: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel gradients, channel-interleaved: [B,H,W,C] ->
    [B,H,W,2C] with out[..., 2c] = gx(c), out[..., 2c+1] = gy(c)."""
    sx, sy = _sobel()
    return _grouped_conv_nhwc(x, np.stack([sx, sy]), 1)


def bank_mix_reference(x: torch.Tensor, a_w: torch.Tensor,
                       b_w: torch.Tensor, *, num_directions: int = 4,
                       coarse_dilation: int = 3) -> torch.Tensor:
    """Plain version: einsum(filtered, a_w, b_w) over the fine/coarse bank.

    x [B,H,W,C]; a_w [B,H,W,K,R] (K = 2*num_directions, k = 2*d + scale);
    b_w [B,H,W,C,R]. Computes in float32, as the kernel accumulates, and
    returns x's dtype."""
    out_dtype = x.dtype
    x, a_w, b_w = x.float(), a_w.float(), b_w.float()
    b, h, w, c = x.shape
    bank = _direction_bank()[:num_directions]
    fine = depthwise_bank_conv(x, bank, dilation=1)
    coarse = depthwise_bank_conv(x, bank, dilation=coarse_dilation)
    filtered = torch.stack([fine, coarse], dim=-1).reshape(
        b, h, w, c, 2 * num_directions)
    out = torch.einsum("bhwck,bhwkr,bhwcr->bhwc", filtered, a_w, b_w)
    return out.to(out_dtype)


def _check_kernel_args(x, a_w, b_w, nd: int, dc: int) -> None:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"bank_mix kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in (("a_w", a_w), ("b_w", b_w)):
        if t.device != x.device:
            raise ValueError(f"bank_mix: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"bank_mix: {name} is {t.dtype}, x is {x.dtype}")
    if not 1 <= nd <= len(_direction_bank()) or dc < 1:
        raise ValueError(f"bank_mix: num_directions={nd} must be in 1..4 "
                         f"and coarse_dilation={dc} >= 1")
    if x.dim() != 4 or a_w.dim() != 5 or b_w.dim() != 5:
        raise ValueError("bank_mix: x must be [B,H,W,C], a_w [B,H,W,K,R], "
                         "b_w [B,H,W,C,R]")
    b, h, w, c = x.shape
    r = a_w.shape[-1]
    if tuple(a_w.shape) != (b, h, w, 2 * nd, r) or \
            tuple(b_w.shape) != (b, h, w, c, r):
        raise ValueError(f"bank_mix: shapes x {tuple(x.shape)}, a_w "
                         f"{tuple(a_w.shape)}, b_w {tuple(b_w.shape)} "
                         f"disagree for num_directions={nd}")
    if not (x.is_contiguous() and a_w.is_contiguous()
            and b_w.is_contiguous()):
        raise ValueError("bank_mix: x, a_w and b_w must be contiguous")


def _pad_to(n: int, residue: int, modulus: int) -> int:
    return -(-(n - residue) // modulus) * modulus + residue


def fwd_min_shared_bytes(c: int, coarse_dilation: int,
                         dtype: torch.dtype = torch.float32,
                         main_path: bool = True) -> int:
    """Shared memory of ``bank_mix_fwd``'s narrowest strip, one pixel
    column and its halo: ``(2 dc + 2) * (1 + 2 dc) * pad(C) * itemsize``.
    ``main_path`` (R = 4, K = 8, C even) pads C to 16 modulo 32 words in
    float32 and 8 modulo 16 words in bfloat16, the scalar path to 8 modulo
    16 elements. The kernel refuses a shape above 232,448 bytes."""
    dc = coarse_dilation
    size = torch.empty((), dtype=dtype).element_size()
    if main_path and c % 2 == 0:
        pad = _pad_to(c, 16, 32) if size == 4 else 2 * _pad_to(c // 2, 8, 16)
    else:
        pad = _pad_to(c, 8, 16)
    return (2 * dc + 2) * (1 + 2 * dc) * pad * size


@functools.lru_cache(maxsize=None)
def _kernel_fn(stem: str, dtype: torch.dtype, n_pointers: int):
    """The C function of ``stem`` for ``dtype``, typed once per process."""
    lib = load_library(stem)
    fn = getattr(lib, f"{stem}_{_KERNEL_DTYPES[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(x, a_w, b_w, nd: int, dc: int) -> torch.Tensor:
    """Check the arguments and launch ``bank_mix_fwd`` on CUDA tensors."""
    _check_kernel_args(x, a_w, b_w, nd, dc)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _kernel_fn("bank_mix_fwd", x.dtype, 4)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_w.data_ptr(), b_w.data_ptr(),
                 out.data_ptr(), b, h, w, c, nd, a_w.shape[-1], dc, stream)
    if err != 0:
        need = fwd_min_shared_bytes(c, dc, x.dtype,
                                    a_w.shape[-1] == 4 and nd == 4)
        raise RuntimeError(
            f"bank_mix_fwd launch failed: cudaError {err}"
            + (": one pixel column with its halo must fit a block, i.e. "
               "(2 dc + 2) * (1 + 2 dc) * pad(C) * itemsize <= 232448 bytes "
               f"of shared memory; got C={c}, dc={dc}: {need} bytes (or "
               "more than 2^31 - 1 blocks)"
               if err == 1 else ""))
    bank_mix.launches += 1
    return out


def _grouped_conv_nhwc_adjoint(dy: torch.Tensor, templates: np.ndarray,
                               dilation: int) -> torch.Tensor:
    """The adjoint of :func:`_grouped_conv_nhwc` (its gradient with respect
    to x): dy [B, H, W, C, F] -> [B, H, W, C]."""
    b, h, w, c, f = dy.shape
    wt = torch.as_tensor(np.tile(templates[None], (c, 1, 1, 1)),
                         dtype=dy.dtype, device=dy.device)
    dx = torch.nn.grad.conv2d_input(
        (b, c, h, w), wt.reshape(c * f, 1, 3, 3),
        dy.reshape(b, h, w, c * f).permute(0, 3, 1, 2), padding=dilation,
        dilation=dilation, groups=c)
    return dx.permute(0, 2, 3, 1)


def bank_mix_bwd_reference(x, a_w, b_w, g, *, num_directions: int = 4,
                           coarse_dilation: int = 3):
    """Plain version of the backward, written out. With f_k the bank's
    filtered x (:func:`bank_mix_reference`) and M_k[c] = sum_r A[k, r]
    B[c, r]: dA[k, r] = sum_c g[c] f_k[c] B[c, r], dB[c, r] = g[c] sum_k
    f_k[c] A[k, r], and dx the banks' adjoints (grouped transposed convs)
    of g M_k. Computes in float32, as the kernel accumulates, with ``g``
    taken in x's dtype; returns (dx, dA, dB) in the inputs' dtypes."""
    dtypes = (x.dtype, a_w.dtype, b_w.dtype)
    g = g.to(x.dtype).float()[..., None]
    x, a_w, b_w = x.float(), a_w.float(), b_w.float()
    b, h, w, c = x.shape
    bank = _direction_bank()[:num_directions]
    fine = depthwise_bank_conv(x, bank, dilation=1)
    coarse = depthwise_bank_conv(x, bank, dilation=coarse_dilation)
    filtered = torch.stack([fine, coarse], dim=-1).reshape(
        b, h, w, c, 2 * num_directions)
    da = torch.einsum("bhwck,bhwcr->bhwkr", g * filtered, b_w)
    db = g * torch.einsum("bhwck,bhwkr->bhwcr", filtered, a_w)
    df = (g * torch.einsum("bhwkr,bhwcr->bhwck", a_w, b_w)).reshape(
        b, h, w, c, num_directions, 2)
    dx = (_grouped_conv_nhwc_adjoint(df[..., 0], bank, 1)
          + _grouped_conv_nhwc_adjoint(df[..., 1], bank, coarse_dilation))
    return tuple(t.to(dt) for t, dt in zip((dx, da, db), dtypes))


def _launch_bwd(x, a_w, b_w, g, nd: int, dc: int):
    """Check the arguments and launch ``bank_mix_bwd`` on CUDA tensors."""
    _check_kernel_args(x, a_w, b_w, nd, dc)
    if g.device != x.device or g.shape != x.shape:
        raise ValueError(f"bank_mix_bwd: g {tuple(g.shape)} on {g.device}, "
                         f"x {tuple(x.shape)} on {x.device}")
    g = g.to(x.dtype).contiguous()
    dx, da, db = (torch.empty_like(t) for t in (x, a_w, b_w))
    if x.numel() == 0:
        return dx, da, db
    fn = _kernel_fn("bank_mix_bwd", x.dtype, 7)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), a_w.data_ptr(), b_w.data_ptr(),
                 dx.data_ptr(), da.data_ptr(), db.data_ptr(), b, h, w, c,
                 nd, a_w.shape[-1], dc, stream)
    if err != 0:
        raise RuntimeError(
            f"bank_mix_bwd launch failed: cudaError {err}"
            + (": one pixel column with its halo must fit a block, i.e. "
               "coarse_dilation <= 19 and (1 + 2 dc) * 4 * (pad(K C) + "
               "(4 dc + 3) pad(C)) <= 232448 bytes of shared memory, pad(n) "
               f"= n rounded up to 8 modulo 16 (16 modulo 32 where R = 4, K "
               f"= 8 and C is even); got C={c}, K={2 * nd}, dc={dc}"
               if err == 1 else ""))
    bank_mix_bwd.launches += 1
    return dx, da, db


# ---------------------------------------------------------------------------
# the kernels as torch.library ops: the plain version for a CPU tensor, the
# kernel for a CUDA tensor, and the FLOP formula from the declared cost
# ---------------------------------------------------------------------------


def bank_mix_cost(x_shape, rank: int, num_directions: int = 4,
                  itemsize: int = 4) -> KernelCost:
    """One call of ``bank_mix_fwd`` on x [B, H, W, C] with rank ``rank``:
    per output element K = 2 num_directions 3-tap means (3 FLOPs each), R
    sums over K (2 K each) and R products with B (2 each); x, A [.., K, R]
    and B [.., C, R] read once and the output written once, ``itemsize``
    bytes an element.

    The Pallas estimate (``forest_tpu/ops/smoothing.py:347``) counts K (2 R
    + 8) FLOPs an element of C and W padded to its tiles, and reads x three
    times (its halo views), in bfloat16."""
    b, h, w, c = x_shape
    k, r, pix = 2 * num_directions, rank, b * h * w
    return KernelCost(flops=pix * c * (3 * k + 2 * k * r + 2 * r),
                      bytes_accessed=itemsize * pix * (2 * c + k * r
                                                       + c * r))


def bank_mix_bwd_cost(x_shape, rank: int, num_directions: int = 4,
                      itemsize: int = 4) -> KernelCost:
    """One call of ``bank_mix_bwd``: per element of x, dx visits the 2 K + 1
    taps ((2 R + 1) FLOPs each) and the centre's R sums over K (2 K R), f_k
    again (3 K), dB (R (2 K + 1)) and dA's share (2 K R); x, g, A, B read
    once and dx, dA, dB written once, ``itemsize`` bytes an element.

    The Pallas estimate (``forest_tpu/ops/smoothing.py:387``) counts K (4 R
    + 16) FLOPs an element of the padded tiles, and every operand's halo
    views three times over."""
    b, h, w, c = x_shape
    k, r, pix = 2 * num_directions, rank, b * h * w
    per = ((2 * k + 1) * (2 * r + 1) + 2 * k * r + 3 * k + r * (2 * k + 1)
           + 2 * k * r)
    return KernelCost(flops=pix * c * per,
                      bytes_accessed=itemsize * pix * (3 * c + 2 * k * r
                                                       + 2 * c * r))


def _plain_fwd(x, a_w, b_w, num_directions, coarse_dilation):
    return bank_mix_reference(x, a_w, b_w, num_directions=num_directions,
                              coarse_dilation=coarse_dilation)


def _plain_bwd(x, a_w, b_w, g, num_directions, coarse_dilation):
    return bank_mix_bwd_reference(x, a_w, b_w, g,
                                  num_directions=num_directions,
                                  coarse_dilation=coarse_dilation)


_library.define(
    "bank_mix_fwd", "(Tensor x, Tensor a_w, Tensor b_w, int num_directions, "
    "int coarse_dilation) -> Tensor", cpu=_plain_fwd, cuda=_launch_fwd,
    fake=lambda x, a_w, b_w, nd, dc: torch.empty_like(x),
    flops=lambda x, a_w, b_w, nd, dc, out_shape=None: bank_mix_cost(
        x, a_w[-1], nd).flops)
_library.define(
    "bank_mix_bwd", "(Tensor x, Tensor a_w, Tensor b_w, Tensor g, "
    "int num_directions, int coarse_dilation) -> (Tensor, Tensor, Tensor)",
    cpu=_plain_bwd, cuda=_launch_bwd,
    fake=lambda x, a_w, b_w, g, nd, dc: tuple(
        torch.empty_like(t) for t in (x, a_w, b_w)),
    flops=lambda x, a_w, b_w, g, nd, dc, out_shape=None: bank_mix_bwd_cost(
        x, a_w[-1], nd).flops)


def _save_inputs(ctx, inputs, output):
    x, a_w, b_w, nd, dc = inputs
    ctx.save_for_backward(x, a_w, b_w)
    ctx.bank = (nd, dc)


def _bank_mix_grad(ctx, g):
    """The gradient of ``bank_mix_fwd``: the ``bank_mix_bwd`` op on the
    saved x, A and B."""
    x, a_w, b_w = ctx.saved_tensors
    nd, dc = ctx.bank
    dx, da, db = bank_mix_bwd(x, a_w, b_w, g, num_directions=nd,
                              coarse_dilation=dc)
    need = ctx.needs_input_grad
    return (dx if need[0] else None, da if need[1] else None,
            db if need[2] else None, None, None)


_library.register_autograd("bank_mix_fwd", _bank_mix_grad, _save_inputs)


def _kernel_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def bank_mix_bwd(x: torch.Tensor, a_w: torch.Tensor, b_w: torch.Tensor,
                 g: torch.Tensor, *, num_directions: int = 4,
                 coarse_dilation: int = 3):
    """Gradients (dx, dA, dB) of :func:`bank_mix` for the cotangent ``g``.

    ``g`` has x's shape and is taken in x's dtype. The op
    ``forest_tpu_torch::bank_mix_bwd``: on CPU tensors
    :func:`bank_mix_bwd_reference`; on CUDA tensors it launches
    ``bank_mix_bwd`` (one kernel, f32 accumulation, no atomics, the same
    bits in every run) on the current stream or raises.
    ``bank_mix_bwd.launches`` counts the launches."""
    _kernel_device("bank_mix_bwd", x)
    return torch.ops.forest_tpu_torch.bank_mix_bwd(
        x, a_w, b_w, g, num_directions, coarse_dilation)


def bank_mix(x: torch.Tensor, a_w: torch.Tensor, b_w: torch.Tensor, *,
             num_directions: int = 4,
             coarse_dilation: int = 3) -> torch.Tensor:
    """Fused fine/coarse directional bank + rank-R mixing, differentiable.

    x [B,H,W,C]; a_w [B,H,W,K,R] softmaxed over K; b_w [B,H,W,C,R]
    softmaxed over R; all contiguous, float32 or bfloat16. The op
    ``forest_tpu_torch::bank_mix_fwd``: on a CPU tensor
    :func:`bank_mix_reference`, on a CUDA tensor ``bank_mix_fwd`` on the
    current stream (f32 accumulation, output in x's dtype) or it raises.
    Its gradient is :func:`bank_mix_bwd` on either."""
    _kernel_device("bank_mix", x)
    return torch.ops.forest_tpu_torch.bank_mix_fwd(
        x, a_w, b_w, num_directions, coarse_dilation)


bank_mix.launches = 0
bank_mix_bwd.launches = 0

__all__ = ["bank_mix", "bank_mix_bwd", "bank_mix_reference",
           "bank_mix_bwd_reference", "bank_mix_cost", "bank_mix_bwd_cost",
           "depthwise_bank_conv", "sobel_grads"]
