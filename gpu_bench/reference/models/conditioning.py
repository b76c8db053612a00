# Frozen copy of forest_tpu_torch/models/conditioning.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""FiLM conditioning: gamma / beta from z_type.

Port of ``forest_tpu/models/conditioning.py``. FiLMLayer: two small MLPs
(Dense -> ReLU -> Dense) with hidden width max(cond, target) // 2 map the
conditioning vector to gamma and beta; ``modulate`` applies gamma * h + beta
(the defaults RepresentationModel uses: derived hidden width, with beta).
:func:`broadcast_to_time` expands per-pixel parameters over the T axis;
:class:`FiLMConditionedBlock` is a dense layer FiLM-modulated by a
conditioner, then ReLU (its parameters under flax's auto names ``Dense_0``
and ``FiLMLayer_0``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class FiLMLayer(nn.Module):
    def __init__(self, cond_dim: int, target_dim: int):
        super().__init__()
        hidden = max(cond_dim, target_dim) // 2
        self.gamma_0 = nn.Linear(cond_dim, hidden)
        self.gamma_1 = nn.Linear(hidden, target_dim)
        self.beta_0 = nn.Linear(cond_dim, hidden)
        self.beta_1 = nn.Linear(hidden, target_dim)

    def forward(self, conditioning: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., cond_dim] -> (gamma, beta), each [..., target_dim]."""
        gamma = self.gamma_1(torch.relu(self.gamma_0(conditioning)))
        beta = self.beta_1(torch.relu(self.beta_0(conditioning)))
        return gamma, beta

    @staticmethod
    def modulate(features: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
        return gamma * features + beta


def broadcast_to_time(params: torch.Tensor, t: int,
                      time_axis: int = 1) -> torch.Tensor:
    """[N, D] -> [N, T, D] (or an axis inserted at ``time_axis`` and
    broadcast to ``t``), a view."""
    expanded = params.unsqueeze(time_axis)
    shape = list(expanded.shape)
    shape[time_axis] = t
    return expanded.expand(shape)


class FiLMConditionedBlock(nn.Module):
    """relu(FiLM(Dense(x); conditioning)): x [..., in_features] and
    conditioning [..., cond_dim] -> [..., features]."""

    def __init__(self, in_features: int, cond_dim: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.FiLMLayer_0 = FiLMLayer(cond_dim, features)

    def forward(self, x: torch.Tensor,
                conditioning: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.FiLMLayer_0(conditioning)
        return torch.relu(FiLMLayer.modulate(self.Dense_0(x), gamma, beta))


__all__ = ["FiLMLayer", "FiLMConditionedBlock", "broadcast_to_time"]
