# Frozen copy of forest_tpu_torch/losses/soft_neighborhood.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Soft neighbourhood matching: row-softmax KL over aligned distance matrices.

Port of ``forest_tpu/losses/soft_neighborhood.py``. Given reference and
learned distance matrices [B, M, M] with a validity mask, form row
distributions p = softmax(-d_ref / tau_ref) and q = softmax(-d_learned /
tau_learned) with a finite -1e9 on masked entries (so a fully masked row
stays NaN-free), take KL(p || q) per row, skip rows with fewer than
``min_valid_per_row`` valid entries, average each pair over its valid rows,
then weight across pairs. All aggregation is by masks, on fixed shapes.

One layout, pairs leading ([B, M, M]): the JAX package's ``mnb`` and
``mnsp`` layouts put the pair axis minor for the TPU's lanes and compute the
same function.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

LARGE_NEG = -1e9


def soft_neighborhood_matching_loss(
        d_reference: torch.Tensor, d_learned: torch.Tensor,
        mask: torch.Tensor, tau_ref: float = 1.0, tau_learned: float = 1.0,
        pair_weights: Optional[torch.Tensor] = None,
        min_valid_per_row: int = 2
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """d_*: [B, M, M] non-negative distances; mask: [B, M, M] bool;
    pair_weights [B]. Returns (scalar loss, stats of 0-d tensors)."""
    if min_valid_per_row < 2:
        raise ValueError(
            f"min_valid_per_row must be >= 2, got {min_valid_per_row}")
    b, m = d_reference.shape[0], d_reference.shape[1]
    mask = mask.bool()
    neg = torch.full((), LARGE_NEG, dtype=d_learned.dtype,
                     device=d_learned.device)
    logits_ref = torch.where(mask, -d_reference / tau_ref, neg)
    logits_lrn = torch.where(mask, -d_learned / tau_learned, neg)

    valid_per_row = mask.sum(2)                               # [B, M]
    row_valid = valid_per_row >= min_valid_per_row

    log_p = torch.log_softmax(logits_ref, dim=2)
    log_q = torch.log_softmax(logits_lrn, dim=2)
    p = torch.exp(log_p)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    contrib = torch.where(mask, p * (log_p - log_q), zero)
    kl_per_row = torch.where(row_valid, contrib.sum(2), zero)

    rows_per_pair = row_valid.to(kl_per_row.dtype).sum(1)     # [B]
    kl_per_pair = kl_per_row.sum(1)
    pair_active = rows_per_pair > 0
    kl_normed = torch.where(
        pair_active, kl_per_pair / torch.clamp(rows_per_pair, min=1.0), zero)

    if pair_weights is None:
        pair_weights = torch.ones_like(kl_normed)
    weights = (pair_weights.reshape(kl_normed.shape)
               * pair_active.to(kl_normed.dtype))
    total_w = weights.sum()
    loss = torch.where(total_w > 0, (weights * kl_normed).sum()
                       / torch.clamp(total_w, min=1e-12), zero)

    with torch.no_grad():
        q = torch.exp(log_q)
        entropy_p = -torch.where(mask, p * log_p, zero).sum(2)
        entropy_q = -torch.where(mask, q * log_q, zero).sum(2)
        rv = row_valid.float()
        denom = torch.clamp(rv.sum(), min=1.0)
        stats = {
            "n_pairs": torch.tensor(b),
            "n_pairs_active": pair_active.sum(),
            "n_rows_total": torch.tensor(b * m),
            "n_rows_valid": row_valid.sum(),
            "mean_kl": loss.detach(),
            "mean_overlap": (valid_per_row * rv).sum() / denom,
            "mean_entropy_p": (entropy_p * rv).sum() / denom,
            "mean_entropy_q": (entropy_q * rv).sum() / denom,
        }
    return loss, stats


def pairwise_sq_distances(x: torch.Tensor) -> torch.Tensor:
    """[..., M, D] -> [..., M, M] squared L2 distances (by the product)."""
    x2 = (x * x).sum(-1)
    xy = x @ x.transpose(-1, -2)
    return torch.clamp(x2[..., :, None] - 2.0 * xy + x2[..., None, :],
                       min=0.0)


__all__ = ["soft_neighborhood_matching_loss", "pairwise_sq_distances",
           "LARGE_NEG"]
