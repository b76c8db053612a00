# Frozen copy of forest_tpu_torch/losses/variance_covariance.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""VICReg-style variance + covariance regularizer.

Port of ``forest_tpu/losses/variance_covariance.py``: a hinge on the
per-dimension std against a target, plus the mean squared off-diagonal
covariance, over the rows a mask selects.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def variance_covariance_loss(z: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             std_target: float = 1.0,
                             variance_weight: float = 1.0,
                             covariance_weight: float = 1.0,
                             eps: float = 1e-4
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Returns (total, variance_term, covariance_term) for z [N, D].

    variance_term = mean_d relu(std_target - std_d)
    covariance_term = (1/D) * sum_{i != j} cov_ij^2
    """
    z = z.float()
    n, d = z.shape
    w = torch.ones(n, device=z.device) if mask is None else mask.float()
    cnt = torch.clamp(w.sum(), min=2.0)
    mu = (z * w[:, None]).sum(0) / cnt
    zc = (z - mu) * w[:, None]
    var = (zc * zc).sum(0) / (cnt - 1.0)
    std = torch.sqrt(var + eps)
    variance_term = torch.relu(std_target - std).mean()

    cov = zc.T @ zc / (cnt - 1.0)
    off = cov * (1.0 - torch.eye(d, dtype=cov.dtype, device=cov.device))
    covariance_term = (off * off).sum() / d

    total = variance_weight * variance_term \
        + covariance_weight * covariance_term
    return total, variance_term, covariance_term


__all__ = ["variance_covariance_loss"]
