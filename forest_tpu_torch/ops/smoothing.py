"""Directional filter bank + rank-R mixing for EdgeAwareSmoothingConv2D.

Port of ``forest_tpu/ops/smoothing.py``. Layout is channel-last NHWC, as in
the JAX package:

- :func:`sobel_grads` and :func:`depthwise_bank_conv` are grouped
  ``F.conv2d`` calls (the fixed Sobel pair and 3-tap direction templates);
- :func:`bank_mix_reference` is the plain PyTorch version of
  ``bank_mix_xla``: both banks as grouped convs, then the per-pixel einsum;
- :func:`bank_mix` is the wrapper of the hand-written CUDA kernels
  ``csrc/bank_mix_fwd.cu`` and, for the gradient, ``csrc/bank_mix_bwd.cu``
  (:func:`bank_mix_bwd`, joined in :class:`BankMixFunction`). A CPU tensor
  goes to the plain versions; a CUDA tensor launches the kernels or raises.
  ``bank_mix.launches`` and ``bank_mix_bwd.launches`` count the launches.

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

from forest_tpu_torch.ops._cuda_build import load_library

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


def bank_mix_bwd_reference(x, a_w, b_w, g, *, num_directions: int = 4,
                           coarse_dilation: int = 3):
    """Plain version of the backward: autograd through
    :func:`bank_mix_reference`. Returns (dx, dA, dB) in the inputs' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, a_w, b_w)]
        out = bank_mix_reference(*leaves, num_directions=num_directions,
                                 coarse_dilation=coarse_dilation)
        return torch.autograd.grad(out, leaves, g.to(out.dtype))


def bank_mix_bwd(x: torch.Tensor, a_w: torch.Tensor, b_w: torch.Tensor,
                 g: torch.Tensor, *, num_directions: int = 4,
                 coarse_dilation: int = 3):
    """Gradients (dx, dA, dB) of :func:`bank_mix` for the cotangent ``g``.

    ``g`` has x's shape and is taken in x's dtype. On CPU tensors this is
    :func:`bank_mix_bwd_reference`; on CUDA tensors it launches
    ``bank_mix_bwd`` (one kernel, f32 accumulation, no atomics, the same
    bits in every run) on the current stream or raises.
    ``bank_mix_bwd.launches`` counts the launches."""
    if x.device.type == "cpu":
        return bank_mix_bwd_reference(
            x, a_w, b_w, g, num_directions=num_directions,
            coarse_dilation=coarse_dilation)
    if x.device.type != "cuda":
        raise ValueError(f"bank_mix_bwd: no kernel for device {x.device}")
    _check_kernel_args(x, a_w, b_w, num_directions, coarse_dilation)
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
                 num_directions, a_w.shape[-1], coarse_dilation, stream)
    if err != 0:
        raise RuntimeError(
            f"bank_mix_bwd launch failed: cudaError {err}"
            + (": one pixel column with its halo must fit a block, i.e. "
               "coarse_dilation <= 19 and (1 + 2 dc) * 4 * (pad(K C) + "
               "(4 dc + 3) pad(C)) <= 232448 bytes of shared memory, pad(n) "
               f"= n rounded up to 8 modulo 16 (16 modulo 32 where R = 4, K "
               f"= 8 and C is even); got C={c}, "
               f"K={2 * num_directions}, dc={coarse_dilation}"
               if err == 1 else ""))
    bank_mix_bwd.launches += 1
    return dx, da, db


class BankMixFunction(torch.autograd.Function):
    """``bank_mix`` on CUDA tensors with its gradient: the forward kernel,
    and the backward kernel on the saved x, A and B."""

    @staticmethod
    def forward(ctx, x, a_w, b_w, num_directions, coarse_dilation):
        ctx.save_for_backward(x, a_w, b_w)
        ctx.bank = (num_directions, coarse_dilation)
        return _launch_fwd(x, a_w, b_w, num_directions, coarse_dilation)

    @staticmethod
    def backward(ctx, g):
        x, a_w, b_w = ctx.saved_tensors
        nd, dc = ctx.bank
        dx, da, db = bank_mix_bwd(x, a_w, b_w, g, num_directions=nd,
                                  coarse_dilation=dc)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, da if need[1] else None,
                db if need[2] else None, None, None)


def bank_mix(x: torch.Tensor, a_w: torch.Tensor, b_w: torch.Tensor, *,
             num_directions: int = 4,
             coarse_dilation: int = 3) -> torch.Tensor:
    """Fused fine/coarse directional bank + rank-R mixing, differentiable.

    x [B,H,W,C]; a_w [B,H,W,K,R] softmaxed over K; b_w [B,H,W,C,R]
    softmaxed over R; all contiguous, float32 or bfloat16. On a CPU tensor
    this is :func:`bank_mix_reference` (autograd differentiates it); on a
    CUDA tensor it is :class:`BankMixFunction`: ``bank_mix_fwd`` on the
    current stream (f32 accumulation, output in x's dtype) and
    ``bank_mix_bwd`` for the gradient, or it raises."""
    if x.device.type == "cpu":
        return bank_mix_reference(x, a_w, b_w, num_directions=num_directions,
                                  coarse_dilation=coarse_dilation)
    if x.device.type != "cuda":
        raise ValueError(f"bank_mix: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or a_w.requires_grad
                                    or b_w.requires_grad):
        return BankMixFunction.apply(x, a_w, b_w, num_directions,
                                     coarse_dilation)
    return _launch_fwd(x, a_w, b_w, num_directions, coarse_dilation)


bank_mix.launches = 0
bank_mix_bwd.launches = 0

__all__ = ["bank_mix", "bank_mix_bwd", "bank_mix_reference",
           "bank_mix_bwd_reference", "BankMixFunction",
           "depthwise_bank_conv", "sobel_grads"]
