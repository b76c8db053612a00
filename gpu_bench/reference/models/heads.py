# Frozen copy of forest_tpu_torch/models/heads.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Output heads: MLP / Linear / Conv2D / SimCLR projection.

Port of ``forest_tpu/models/heads.py``, channel-last, with the flax module
names (``hidden_{i}`` and ``out``, ``Dense_0``, ``Conv_0`` / ``Conv_1``,
``fc1`` / ``norm`` / ``fc2``) so ``utils.flax_bridge`` carries parameters
over one to one. The projection head's LayerNorm keeps flax's epsilon,
1e-6 (``torch.nn.LayerNorm`` defaults to 1e-5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

FLAX_LAYER_NORM_EPS = 1e-6


class MLPHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 output_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        self.dropout_rate = dropout_rate
        dims = (in_dim,) + tuple(hidden_dims)
        for i in range(self.n_hidden):
            setattr(self, f"hidden_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.out = nn.Linear(dims[-1], output_dim)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
            if self.dropout_rate > 0:
                x = F.dropout(x, self.dropout_rate,
                              training=not deterministic)
        return self.out(x)


class LinearHead(nn.Module):
    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class Conv2DHead(nn.Module):
    """[B, H, W, C] -> [B, H, W, output_dim]: an optional conv + ReLU, then
    a conv, both 'SAME' padded."""

    def __init__(self, in_dim: int, output_dim: int,
                 hidden_dim: Optional[int] = None, kernel_size: int = 1):
        super().__init__()
        k = kernel_size
        if hidden_dim:
            self.Conv_0 = nn.Conv2d(in_dim, hidden_dim, k, padding="same")
            self.Conv_1 = nn.Conv2d(hidden_dim, output_dim, k,
                                    padding="same")
        else:
            self.Conv_0 = nn.Conv2d(in_dim, output_dim, k, padding="same")
        self.hidden = bool(hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        if self.hidden:
            h = self.Conv_1(torch.relu(self.Conv_0(h)))
        else:
            h = self.Conv_0(h)
        return h.permute(0, 2, 3, 1)


class MLPProjectionHead(nn.Module):
    """SimCLR-style: Dense -> LayerNorm -> ReLU -> Dense [-> L2 normalise,
    z / (||z|| + 1e-8)]."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 l2_normalize: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=FLAX_LAYER_NORM_EPS)
        self.fc2 = nn.Linear(hidden_dim, output_dim)
        self.l2_normalize = l2_normalize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.fc2(torch.relu(self.norm(self.fc1(x))))
        if self.l2_normalize:
            z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True)
                     + 1e-8)
        return z


__all__ = ["MLPHead", "LinearHead", "Conv2DHead", "MLPProjectionHead"]
