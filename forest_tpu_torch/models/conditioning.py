"""FiLM conditioning: gamma / beta from z_type.

Port of ``forest_tpu/models/conditioning.py``'s FiLMLayer: two small MLPs
(Dense -> ReLU -> Dense) with hidden width max(cond, target) // 2 map the
conditioning vector to gamma and beta; ``modulate`` applies gamma * h + beta.
Only the defaults RepresentationModel uses are ported (derived hidden
width, with beta).
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


__all__ = ["FiLMLayer"]
