# Frozen copy of forest_tpu_torch/losses/triplet_phase.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Phase triplet ordering and recovery discrimination losses.

Port of ``forest_tpu/losses/triplet_phase.py``:

- three sampled years t0 < t1 < t2 per pixel; the ysfc series puts each
  pixel in one of four cases (disturbance only in (t0, t1), only in
  (t1, t2), none, or skip: a disturbance at a sampled year or in both
  intervals), each with up to three ordering constraints on the squared
  distances of the three embeddings, as soft margins
  ``softplus(d_close - d_far + margin)`` averaged over the constraints;
- :func:`phase_recovery_discrimination_loss`: per pixel
  ``softplus(margin - ||z(ysfc <= low) - z(ysfc >= high)||)`` over every
  (disturbed, recovered) pair of its timesteps.

The per-case constraint tables are a static [4, 3, ...] lookup indexed by
the case: every pixel carries three constraint slots with a validity mask.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# [case, slot, (closer_a, closer_b, farther_a, farther_b)];
# case 0 = d01, 1 = d12, 2 = none, 3 = skip
_SLOTS = np.zeros((4, 3, 4), np.int64)
_LARGE = np.zeros((4, 3), bool)
_VALID = np.zeros((4, 3), bool)
_SLOTS[0] = [(1, 2, 0, 1), (1, 2, 0, 2), (0, 2, 0, 1)]
_LARGE[0] = [True, True, False]
_VALID[0] = [True, True, True]
_SLOTS[1] = [(0, 1, 1, 2), (0, 1, 0, 2), (0, 2, 1, 2)]
_LARGE[1] = [True, True, False]
_VALID[1] = [True, True, True]
_SLOTS[2] = [(0, 1, 0, 2), (1, 2, 0, 2), (0, 0, 0, 0)]
_LARGE[2] = [False, False, False]
_VALID[2] = [True, True, False]


def classify_triplet_batch(ysfc: torch.Tensor, t0: int, t1: int,
                           t2: int) -> torch.Tensor:
    """Per-pixel case [N] int64: 0 = d01, 1 = d12, 2 = none, 3 = skip."""
    n = ysfc.shape[0]
    none = torch.zeros(n, dtype=torch.bool, device=ysfc.device)
    at_sample = (ysfc[:, t0] == 0) | (ysfc[:, t1] == 0) | (ysfc[:, t2] == 0)
    d01 = (ysfc[:, t0 + 1:t1] == 0).any(1) if t1 > t0 + 1 else none
    d12 = (ysfc[:, t1 + 1:t2] == 0).any(1) if t2 > t1 + 1 else none
    skip = at_sample | (d01 & d12)
    case = torch.where(d01 & ~d12, 0, torch.where(d12 & ~d01, 1, 2))
    return torch.where(skip, 3, case)


def phase_triplet_loss(embeddings_t0: torch.Tensor,
                       embeddings_t1: torch.Tensor,
                       embeddings_t2: torch.Tensor, ysfc: torch.Tensor,
                       t0_idx: int, t1_idx: int, t2_idx: int,
                       large_margin: float = 1.0, small_margin: float = 0.3
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """embeddings_t* [N, D]; ysfc [N, T] -> (loss, stats)."""
    dev = embeddings_t0.device
    n = embeddings_t0.shape[0]
    case = classify_triplet_batch(ysfc, t0_idx, t1_idx, t2_idx)   # [N]
    slots = torch.as_tensor(_SLOTS, device=dev)[case]             # [N, 3, 4]
    is_large = torch.as_tensor(_LARGE, device=dev)[case]          # [N, 3]
    valid = torch.as_tensor(_VALID, device=dev)[case] & (case[:, None] != 3)

    emb = torch.stack([embeddings_t0, embeddings_t1, embeddings_t2], 1)
    rows = torch.arange(n, device=dev)[:, None]

    def pick(sl):
        return emb[rows, sl]                                      # [N, 3, D]

    d_close = ((pick(slots[..., 0]) - pick(slots[..., 1])) ** 2).sum(-1)
    d_far = ((pick(slots[..., 2]) - pick(slots[..., 3])) ** 2).sum(-1)
    margin = torch.where(is_large, large_margin, small_margin)
    violation = d_close - d_far + margin
    per = torch.nn.functional.softplus(violation) * valid.to(d_close.dtype)
    k = valid.sum()
    loss = per.sum() / torch.clamp(k, min=1)
    with torch.no_grad():
        stats = {
            "n_constraints": k,
            "n_large": (is_large & valid).sum(),
            "n_small": (~is_large & valid).sum(),
            "n_pixels_valid": (case != 3).sum(),
            "n_pixels_skipped": (case == 3).sum(),
            # no valid constraint: vacuously all satisfied
            "frac_satisfied": torch.where(
                k > 0, ((violation < 0) & valid).sum()
                / torch.clamp(k, min=1), torch.ones((), device=dev)),
        }
    return loss, stats


def phase_recovery_discrimination_loss(
        z_phase: torch.Tensor, ysfc: torch.Tensor, margin: float = 0.5,
        low_ysfc_max: float = 1.0, high_ysfc_min: float = 5.0
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z_phase [N, T, D]; ysfc [N, T] (NaN = invalid).

    Coincident embeddings have an infinite derivative of the distance, so
    the squared distance is floored at 1e-12 before the square root, and
    only inside the (disturbed, recovered) pairs: elsewhere, as at a pixel
    the caller masked by zeroing its embedding, the floor's zero gradient
    holds and no NaN reaches the parameters."""
    valid = torch.isfinite(ysfc) & (ysfc >= 0)
    is_low = valid & (ysfc <= low_ysfc_max)
    is_high = valid & (ysfc >= high_ysfc_min)
    active = is_low.any(1) & is_high.any(1)                       # [N]
    pair_mask = (is_low[:, :, None] & is_high[:, None, :]
                 & active[:, None, None])                         # [N, T, T]
    d2 = ((z_phase[:, :, None, :] - z_phase[:, None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    per = torch.nn.functional.softplus(margin - d) * pair_mask.to(d.dtype)
    n_pairs = pair_mask.sum()
    loss = per.sum() / torch.clamp(n_pairs, min=1)
    return loss, {"n_pairs": n_pairs, "n_active_pixels": active.sum()}


__all__ = ["phase_triplet_loss", "phase_recovery_discrimination_loss",
           "classify_triplet_batch"]
