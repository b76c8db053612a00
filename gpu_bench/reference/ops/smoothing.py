# Frozen copy of forest_tpu_torch/ops/smoothing.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Directional filter bank + rank-R mixing, plain PyTorch.

The plain versions of the port's ``ops/smoothing.py``: the banks as
grouped convolutions and the per-pixel einsum. :func:`bank_mix` is
:func:`bank_mix_reference`, differentiated by autograd.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


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



bank_mix = bank_mix_reference
