# Frozen copy of forest_tpu_torch/models/tcn.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Temporal convolutional encoder (dilated, centred, gated).

Port of ``forest_tpu/models/tcn.py``. A GatedResidualBlock computes
h = GroupNorm(dilated conv1d(drop(x))) with pad (k-1)*d//2 on both sides,
gate = sigmoid(1x1 conv(h)) and out = gate * relu(h) + (1 - gate) * res,
where res is x, 1x1-projected when the width changes. TCNEncoder stacks
blocks and pools with 'none' or 'stats' (masked mean and std over time).

TCNEncoder takes the JAX layouts: pixel series [N, T, C], or the spatial
form [B, T, H, W, C] (mask [B, T, H, W]), whose pixels are folded into the
series axis in (b, h, w) order and unfolded after, as the JAX module does;
the blocks work on torch's Conv1d layout [N, C, T] so the stack
transposes once.

Dropout (training only, ``dropout_rate`` > 0): at each block's input, flax's
``Dropout(broadcast_dims=(1,))``: whole channels are zeroed across time and
the kept ones scaled by 1 / (1 - rate). The mask of a block is ``u < 1 -
rate`` for a uniform draw ``u`` [N, 1, C_in] (the JAX layout), one per block
(:meth:`TCNEncoder.draw`), given by the caller so that a test can feed
another framework's numbers.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gpu_bench.reference.models.conv2d_encoder import fit_groups
from gpu_bench.reference.utils.draws import uniform


class GatedResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 num_groups: int = 8, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.projection = (nn.Conv1d(in_channels, out_channels, 1)
                           if in_channels != out_channels else None)
        pad = (kernel_size - 1) * dilation // 2
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              dilation=dilation, padding=pad)
        self.norm = nn.GroupNorm(fit_groups(num_groups, out_channels),
                                 out_channels, eps=1e-5)
        self.gate = nn.Conv1d(out_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N, C_in, T] -> [N, C_out, T]; ``u`` [N, 1, C_in] the dropout
        draw (None: no dropout)."""
        residual = x if self.projection is None else self.projection(x)
        h = x
        if u is not None and self.dropout_rate > 0.0:
            keep_p = 1.0 - self.dropout_rate
            keep = u.to(x.device).transpose(1, 2) < keep_p   # [N, C_in, 1]
            h = (torch.where(keep, x / keep_p, torch.zeros_like(x))
                 if keep_p > 0.0 else torch.zeros_like(x))
        h = self.norm(self.conv(h))
        gate = torch.sigmoid(self.gate(h))
        return gate * torch.relu(h) + (1.0 - gate) * residual


class TCNEncoder(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_size: int = 3,
                 dilations: Optional[Sequence[int]] = None,
                 num_groups: int = 8, pooling: str = "none",
                 dropout_rate: float = 0.0):
        super().__init__()
        if pooling not in ("none", "stats"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.pooling = pooling
        self.dropout_rate = float(dropout_rate)
        dil = list(dilations or [2 ** i for i in range(len(channels))])
        c_prev = in_channels
        self.in_widths = []
        for i, (ch, d) in enumerate(zip(channels, dil)):
            self.add_module(f"block_{i}", GatedResidualBlock(
                c_prev, ch, kernel_size, d, num_groups, dropout_rate))
            self.in_widths.append(c_prev)
            c_prev = ch
        self.n_blocks = len(channels)

    def draw(self, n: int, generator: Optional[torch.Generator],
             device) -> Tuple[torch.Tensor, ...]:
        """The uniform draws of one training forward over n series: one
        [n, 1, C_in] per block, none when ``dropout_rate`` is 0."""
        if self.dropout_rate <= 0.0:
            return ()
        return tuple(uniform((n, 1, c), generator, device)
                     for c in self.in_widths)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                draws: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> torch.Tensor:
        """x [N, T, C]; mask [N, T] (stats pooling only) -> [N, T, C_out]
        ('none') or [N, 2 C_out] ('stats': mean and std over time). The
        spatial form x [B, T, H, W, C], mask [B, T, H, W] -> [B, T, H, W,
        C_out] or [B, H, W, 2 C_out], over N = B*H*W series.
        ``deterministic=False`` turns the blocks' dropout on with
        ``draws`` (:meth:`draw`'s layout), which it then requires."""
        if x.ndim == 5:
            b, t, h, w, c = x.shape
            flat = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
            if mask is not None:
                mask = mask.permute(0, 2, 3, 1).reshape(b * h * w, t)
            y = self(flat, mask, deterministic=deterministic, draws=draws)
            if self.pooling == "stats":
                return y.reshape(b, h, w, -1)
            return y.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)
        if deterministic or self.dropout_rate <= 0.0:
            draws = (None,) * self.n_blocks
        elif draws is None:
            raise ValueError("dropout needs draws: pass TCNEncoder.draw(...)")
        y = x.transpose(1, 2)
        for i in range(self.n_blocks):
            y = getattr(self, f"block_{i}")(y, draws[i])
        if self.pooling == "stats":
            if mask is not None:
                m = mask.to(y.dtype).unsqueeze(1)  # [N, 1, T]
                cnt = torch.clamp(m.sum(dim=2), min=1.0)
                mean = (y * m).sum(dim=2) / cnt
                var = (((y - mean.unsqueeze(2)) ** 2) * m).sum(dim=2) / cnt
                std = torch.sqrt(var + 1e-8)
            else:
                mean = y.mean(dim=2)
                std = y.std(dim=2, correction=1)
            return torch.cat([mean, std], dim=-1)
        return y.transpose(1, 2)


__all__ = ["TCNEncoder", "GatedResidualBlock"]
