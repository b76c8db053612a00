"""Pair construction: chunked mutual-kNN over pooled anchors.

Port of the part of ``forest_tpu/losses/pairs.py`` that the cross-batch
spectral loss needs: ``_chunked_knn_idx`` and ``mutual_knn_grouped``. The
other builders of that file (kNN / quantile / radius pair lists) have no
caller in the FRL step and are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunked_knn_idx(features: torch.Tensor, k: int, chunk_size: int,
                     patch_ids: Optional[torch.Tensor],
                     coords: Optional[torch.Tensor],
                     pos_min_spatial: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN indices [N, k'] + validity, one [chunk, N] distance block at a
    time; k' = min(k, N - 1). Same-patch candidates closer than
    ``pos_min_spatial`` pixels are excluded."""
    n = features.shape[0]
    dev = features.device
    f2 = (features * features).sum(1)
    cols = torch.arange(n, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    kk = min(k, n - 1)
    idxs, valids = [], []
    for start in range(0, n, chunk_size):
        rows = cols[start:start + chunk_size]
        q = features[rows]
        d = f2[rows][:, None] - 2.0 * q @ features.T + f2[None, :]
        d = torch.where(rows[:, None] == cols[None, :], inf, d)
        if patch_ids is not None and coords is not None:
            same_patch = patch_ids[rows][:, None] == patch_ids[None, :]
            sp2 = ((coords[rows].float()[:, None]
                    - coords.float()[None]) ** 2).sum(-1)
            d = torch.where(same_patch & (sp2 < pos_min_spatial ** 2), inf,
                            d)
        neg, idx = torch.topk(-d, kk, dim=1)
        idxs.append(idx)
        valids.append(torch.isfinite(neg))
    return torch.cat(idxs), torch.cat(valids)


def mutual_knn_grouped(features: torch.Tensor, k: int,
                       patch_ids: Optional[torch.Tensor] = None,
                       coords: Optional[torch.Tensor] = None,
                       pos_min_spatial: float = 4.0,
                       chunk_size: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-kNN in anchor-major grouped form: (knn_idx [N, k'],
    valid [N, k'] with the mutuality filter applied): j stays a neighbour of
    i only if i is also among j's k nearest."""
    n = features.shape[0]
    knn_idx, knn_valid = _chunked_knn_idx(features, k, chunk_size,
                                          patch_ids, coords,
                                          pos_min_spatial)
    rows = torch.arange(n, device=features.device)[:, None].expand_as(
        knn_idx)
    member = torch.zeros((n, n), dtype=torch.bool, device=features.device)
    member[rows, knn_idx] = knn_valid
    return knn_idx, knn_valid & member[knn_idx, rows]


__all__ = ["mutual_knn_grouped"]
