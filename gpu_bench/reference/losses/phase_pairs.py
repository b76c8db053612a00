# Frozen copy of forest_tpu_torch/losses/phase_pairs.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Phase pair construction: spectral kNN -> ysfc-overlap filter -> weights.

Port of ``forest_tpu/losses/phase_pairs.py``:

  stage 1: k nearest spectral neighbours per anchor, self excluded (and
           invalid anchors, with ``valid_anchors``, out of the candidates);
  stage 2: keep pairs sharing >= ``min_overlap`` distinct ysfc values;
  stage 3: drop anchors with < ``min_pairs`` surviving cross pairs;
  weights: ``exp(-||spec_i - spec_j|| / sigma)``; self pairs (i, i) at
           ``self_pair_weight`` for surviving anchors.

Fixed output shapes: pairs [N*k + N, 2] with a validity mask (the cross
candidates, then one self-pair slot per anchor). Leading axes before N are
batch axes (one independent problem per sample), which is how the train
step calls it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gpu_bench.reference.ops.topk import top_k


def ysfc_overlap_matrix(ysfc: torch.Tensor, num_classes: int
                        ) -> torch.Tensor:
    """[..., N, T] ysfc series -> [..., N, N] float32 counts of the distinct
    values two series share. NaN, negative and out-of-range values are
    ignored (validity is decided in floating point: an integer cast of NaN
    could alias 0, the disturbance year)."""
    ok = torch.isfinite(ysfc) & (ysfc >= 0) & (ysfc < num_classes)
    y = torch.where(ok, ysfc, torch.zeros_like(ysfc)).long().clamp(
        0, num_classes - 1)
    presence = torch.zeros(*ysfc.shape[:-1], num_classes,
                           dtype=torch.float32, device=ysfc.device)
    presence.scatter_reduce_(-1, y, ok.float(), reduce="amax")
    return presence @ presence.transpose(-1, -2)


def build_phase_pairs(spec_features: torch.Tensor, ysfc: torch.Tensor,
                      k: int = 16, min_overlap: int = 3, min_pairs: int = 5,
                      include_self: bool = True, sigma: float = 5.0,
                      self_pair_weight: float = 1.0,
                      num_ysfc_classes: int = 64,
                      valid_anchors: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 Dict[str, torch.Tensor]]:
    """spec_features [..., N, C]; ysfc [..., N, T]; valid_anchors [..., N].
    Returns (pairs [..., N*k+N, 2] int64, weights [..., N*k+N], valid
    [..., N*k+N], stats). Pair construction carries no gradient."""
    x = spec_features.detach().float()
    n = x.shape[-2]
    lead = x.shape[:-2]
    dev = x.device
    k = min(k, max(n - 1, 1))

    # stage 1: spectral kNN (L2), self excluded
    x2 = (x * x).sum(-1)
    d2 = torch.clamp(x2[..., :, None] - 2.0 * (x @ x.transpose(-1, -2))
                     + x2[..., None, :], min=0.0)
    d = torch.sqrt(d2)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    d_noself = torch.where(eye, inf, d)
    if valid_anchors is not None:
        va = valid_anchors.bool()
        d_noself = torch.where(va[..., None, :], d_noself, inf)
    _, knn_idx = top_k(-d_noself, k)                        # [..., N, k]

    anchor = torch.arange(n, device=dev).repeat_interleave(k)  # [N*k]
    target = knn_idx.reshape(*lead, n * k)
    cand_valid = torch.full((*lead, n * k), n > 1, dtype=torch.bool,
                            device=dev)
    if valid_anchors is not None:
        cand_valid = cand_valid & va[..., anchor] & torch.gather(
            va, -1, target)

    # stage 2: ysfc overlap filter
    overlap = ysfc_overlap_matrix(ysfc, num_ysfc_classes)   # [..., N, N]
    pair_overlap = torch.gather(overlap[..., anchor, :], -1,
                                target[..., None])[..., 0]
    ok = cand_valid & (pair_overlap >= min_overlap)

    # stage 3: anchors need >= min_pairs surviving cross pairs
    per_anchor = ok.reshape(*lead, n, k).sum(-1)
    anchors_ok = per_anchor >= min_pairs                    # [..., N]
    cross_valid = ok & anchors_ok[..., anchor]

    cross_d = torch.gather(d[..., anchor, :], -1, target[..., None])[..., 0]
    cross_w = torch.exp(-cross_d / sigma)

    self_valid = anchors_ok & bool(include_self)
    if valid_anchors is not None:
        self_valid = self_valid & va
    ar = torch.arange(n, device=dev).expand(*lead, n)
    pairs = torch.cat([torch.stack([anchor.expand(*lead, n * k), target],
                                   -1),
                       torch.stack([ar, ar], -1)], dim=-2)
    weights = torch.cat([cross_w, torch.full((*lead, n), self_pair_weight,
                                             device=dev)], -1)
    valid = torch.cat([cross_valid, self_valid], -1)

    cv = cross_valid.float()
    ncross = torch.clamp(cv.sum(-1), min=1.0)
    stats = {
        "n_anchors_surviving": anchors_ok.sum(-1),
        "n_candidates": cand_valid.sum(-1),
        "n_after_overlap": ok.sum(-1),
        "n_self_pairs": self_valid.sum(-1),
        "n_total_pairs": valid.sum(-1),
        "overlap_mean": (pair_overlap * cv).sum(-1) / ncross,
        "weight_mean": (cross_w * cv).sum(-1) / ncross,
        "dist_mean": (cross_d * cv).sum(-1) / ncross,
    }
    return pairs, weights, valid, stats


__all__ = ["build_phase_pairs", "ysfc_overlap_matrix"]
