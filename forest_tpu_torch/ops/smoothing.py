"""Directional filter bank + rank-R mixing for EdgeAwareSmoothingConv2D.

Port of ``forest_tpu/ops/smoothing.py``. Layout is channel-last NHWC, as in
the JAX package:

- :func:`sobel_grads` and :func:`depthwise_bank_conv` are grouped
  ``F.conv2d`` calls (the fixed Sobel pair and 3-tap direction templates);
- :func:`bank_mix_reference` is the plain PyTorch version of
  ``bank_mix_xla``: both banks as grouped convs, then the per-pixel einsum;
- :func:`bank_mix` is the wrapper of the hand-written CUDA kernel
  ``csrc/bank_mix_fwd.cu``. A CPU tensor goes to the plain version; a CUDA
  tensor launches the kernel or raises. ``bank_mix.launches`` counts the
  launches.
"""
from __future__ import annotations

import ctypes
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


def _kernel_fn(dtype: torch.dtype):
    lib = load_library("bank_mix_fwd")
    fn = getattr(lib, f"bank_mix_fwd_{_KERNEL_DTYPES[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bank_mix(x: torch.Tensor, a_w: torch.Tensor, b_w: torch.Tensor, *,
             num_directions: int = 4,
             coarse_dilation: int = 3) -> torch.Tensor:
    """Fused fine/coarse directional bank + rank-R mixing (forward only).

    x [B,H,W,C]; a_w [B,H,W,K,R] softmaxed over K; b_w [B,H,W,C,R]
    softmaxed over R; all contiguous, float32 or bfloat16. On a CPU tensor
    this is :func:`bank_mix_reference`; on a CUDA tensor it launches
    ``bank_mix_fwd`` on the current stream (f32 accumulation, output in x's
    dtype) or raises."""
    if x.device.type == "cpu":
        return bank_mix_reference(x, a_w, b_w, num_directions=num_directions,
                                  coarse_dilation=coarse_dilation)
    if x.device.type != "cuda":
        raise ValueError(f"bank_mix: no kernel for device {x.device}")
    _check_kernel_args(x, a_w, b_w, num_directions, coarse_dilation)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _kernel_fn(x.dtype)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_w.data_ptr(), b_w.data_ptr(),
                 out.data_ptr(), b, h, w, c, num_directions, a_w.shape[-1],
                 coarse_dilation, stream)
    if err != 0:
        # 1 (cudaErrorInvalidValue): an image row W*C above 65535 * 256 or
        # B*H above 2^31 - 1, the limits of the kernel's grid
        raise RuntimeError(f"bank_mix_fwd launch failed: cudaError {err}")
    bank_mix.launches += 1
    return out


bank_mix.launches = 0

__all__ = ["bank_mix", "bank_mix_reference", "depthwise_bank_conv",
           "sobel_grads"]
