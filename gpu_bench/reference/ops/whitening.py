# Frozen copy of forest_tpu_torch/ops/whitening.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Mahalanobis whitening on tensors.

Port of ``forest_tpu/ops/whitening.py``: W = chol((Sigma + eps I)^-1)^T is
computed once on the host in numpy; ``apply_whitening`` computes
clip(W (x - mu), +/-clip) with invalid entries (NaN or mask 0) zeroed
before the matmul and again after.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def whitening_matrix(cov: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Host-side: W such that W x has identity covariance (x @ W.T)."""
    cov = np.asarray(cov, np.float64)
    c = cov.shape[0]
    prec = np.linalg.inv(cov + eps * np.eye(c))
    return np.linalg.cholesky(prec).T.astype(np.float32)


def apply_whitening(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    clip: float = 5.0) -> torch.Tensor:
    """x [..., C] -> whitened, clipped, NaN-safe."""
    finite = torch.isfinite(x)
    if mask is not None:
        finite = finite & (mask > 0)
    xc = torch.where(finite, x - mean, torch.zeros_like(x))
    out = torch.clamp(torch.einsum("...c,dc->...d", xc, w), -clip, clip)
    return torch.where(finite, out, torch.zeros_like(out))


__all__ = ["whitening_matrix", "apply_whitening"]
