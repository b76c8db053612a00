"""Conv2DEncoder for inference: (conv -> GroupNorm -> ReLU) x N.

Port of ``forest_tpu/models/conv2d_encoder.py`` as RepresentationModel
uses it: bias-free convs, GroupNorm with eps 1e-5, ReLU on every stage but
the last. Channel-last NHWC in and out. Dropout is the identity at
inference, so the module has none; training-time dropout, other
activations and the trailing projection are not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def fit_groups(requested: int, channels: int) -> int:
    """Largest divisor of ``channels`` that is <= ``requested``."""
    g = max(1, min(requested, channels))
    while channels % g:
        g -= 1
    return g


class Conv2DEncoder(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_size: int = 1, num_groups: int = 8):
        super().__init__()
        self.n_layers = len(channels)
        c_prev = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"conv_{i}", nn.Conv2d(c_prev, c, kernel_size,
                                                   padding="same",
                                                   bias=False))
            self.add_module(f"norm_{i}", nn.GroupNorm(
                fit_groups(num_groups, c), c, eps=1e-5))
            c_prev = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C_in] -> [B, H, W, channels[-1]]."""
        h = x.permute(0, 3, 1, 2)
        for i in range(self.n_layers):
            h = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(h))
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h.permute(0, 2, 3, 1)


__all__ = ["Conv2DEncoder", "fit_groups"]
