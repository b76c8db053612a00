"""Temporal convolutional encoder (dilated, centred, gated) for inference.

Port of ``forest_tpu/models/tcn.py``. A GatedResidualBlock computes
h = GroupNorm(dilated conv1d(x)) with pad (k-1)*d//2 on both sides,
gate = sigmoid(1x1 conv(h)) and out = gate * relu(h) + (1 - gate) * res,
where res is x, 1x1-projected when the width changes. TCNEncoder stacks
blocks and pools with 'none' or 'stats' (masked mean and std over time).

TCNEncoder takes the JAX layout [N, T, C] (pixel series; the spatial
[B, T, H, W, C] form is not ported: RepresentationModel flattens pixels
itself); the blocks work on torch's Conv1d layout [N, C, T] so the stack
transposes once. Dropout is the identity (inference only).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from forest_tpu_torch.models.conv2d_encoder import fit_groups


class GatedResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dilation: int = 1,
                 num_groups: int = 8):
        super().__init__()
        self.projection = (nn.Conv1d(in_channels, out_channels, 1)
                           if in_channels != out_channels else None)
        pad = (kernel_size - 1) * dilation // 2
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              dilation=dilation, padding=pad)
        self.norm = nn.GroupNorm(fit_groups(num_groups, out_channels),
                                 out_channels, eps=1e-5)
        self.gate = nn.Conv1d(out_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C_in, T] -> [N, C_out, T]."""
        residual = x if self.projection is None else self.projection(x)
        h = self.norm(self.conv(x))
        gate = torch.sigmoid(self.gate(h))
        return gate * torch.relu(h) + (1.0 - gate) * residual


class TCNEncoder(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_size: int = 3,
                 dilations: Optional[Sequence[int]] = None,
                 num_groups: int = 8, pooling: str = "none"):
        super().__init__()
        if pooling not in ("none", "stats"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.pooling = pooling
        dil = list(dilations or [2 ** i for i in range(len(channels))])
        c_prev = in_channels
        for i, (ch, d) in enumerate(zip(channels, dil)):
            self.add_module(f"block_{i}", GatedResidualBlock(
                c_prev, ch, kernel_size, d, num_groups))
            c_prev = ch
        self.n_blocks = len(channels)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [N, T, C]; mask [N, T] (stats pooling only) -> [N, T, C_out]
        ('none') or [N, 2 C_out] ('stats': mean and std over time)."""
        y = x.transpose(1, 2)
        for i in range(self.n_blocks):
            y = getattr(self, f"block_{i}")(y)
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
