# Frozen copy of forest_tpu_torch/losses/pairs.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Pair construction: kNN / mutual-kNN / quantile / radius / chunked.

Port of ``forest_tpu/losses/pairs.py``. Every builder returns fixed-size
outputs with validity masks, as the JAX package's do:

- :func:`pairs_knn`: [N*k, 2] pairs + valid (the k smallest distances of
  each row; self and invalid or infinite entries excluded);
- :func:`pairs_mutual_knn`: the same, valid only where each is in the
  other's k nearest; :func:`knn_membership` the [N, N] membership;
- :func:`pairs_quantile` / :func:`pairs_radius`: boolean adjacency [N, M]
  of the global quantile band [low, q) of the valid distances / the
  distance band [min_dist, radius), and :func:`mask_to_pairs` to pick a
  fixed number of index pairs from an adjacency;
- :func:`apply_spatial_constraint` / :func:`pairs_with_spatial_constraint`:
  spatially close candidates masked out of the feature distances first;
- :func:`pairs_mutual_knn_chunked` / :func:`mutual_knn_grouped`: mutual kNN
  over pooled anchors, one [chunk, N] distance block at a time, with the
  within-patch spatial exclusion (the cross-batch spectral loss's).

The k smallest of a row are taken by a stable sort, so ties (masked
entries) keep the lowest index first, as ``lax.top_k`` orders them; the
chunked builder keeps ``torch.topk``. :func:`mask_to_pairs` takes its
random scores (``uniform``) or draws them from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpu_bench.reference.utils.draws import uniform as draw_uniform

INF = float("inf")


def _sanitize(distances: torch.Tensor, valid_mask: Optional[torch.Tensor],
              exclude_self: bool = True) -> torch.Tensor:
    inf = torch.full((), INF, dtype=distances.dtype,
                     device=distances.device)
    d = torch.where(torch.isfinite(distances), distances, inf)
    n, m = d.shape
    if valid_mask is not None:
        vm = valid_mask.to(torch.bool)
        d = torch.where(vm[None, :], d, inf)
        if vm.shape[0] == n:
            d = torch.where(vm[:, None], d, inf)
    if exclude_self and n == m:
        d = torch.where(torch.eye(n, dtype=torch.bool, device=d.device),
                        inf, d)
    return d


def _smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest of each row, ties in index
    order."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _pair_list(idx: torch.Tensor) -> torch.Tensor:
    n, k = idx.shape
    rows = torch.arange(n, device=idx.device)[:, None].expand(n, k)
    return torch.stack([rows.reshape(-1), idx.reshape(-1)], 1).int()


def pairs_knn(distances: torch.Tensor, k: int,
              valid_mask: Optional[torch.Tensor] = None,
              symmetric: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row. Returns (pairs [N*k (x2 if symmetric), 2] int32,
    valid)."""
    d = _sanitize(distances, valid_mask)
    vals, idx = _smallest(d, min(k, d.shape[1]))
    pairs, valid = _pair_list(idx), torch.isfinite(vals).reshape(-1)
    if symmetric:
        pairs = torch.cat([pairs, pairs.flip(1)])
        valid = torch.cat([valid, valid])
    return pairs, valid


def _knn_membership_parts(distances: torch.Tensor, k: int,
                          valid_mask: Optional[torch.Tensor]):
    """(member [N, N] bool, idx [N, k], valid [N, k])."""
    n = distances.shape[0]
    vals, idx = _smallest(_sanitize(distances, valid_mask), min(k, n))
    valid = torch.isfinite(vals)
    member = torch.zeros((n, n), dtype=torch.bool, device=idx.device)
    member[torch.arange(n, device=idx.device)[:, None], idx] = valid
    return member, idx, valid


def knn_membership(distances: torch.Tensor, k: int,
                   valid_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Boolean [N, N]: member[i, j] = j is among i's (valid) k nearest."""
    return _knn_membership_parts(distances, k, valid_mask)[0]


def pairs_mutual_knn(distances: torch.Tensor, k: int,
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual kNN: (pairs [N*k, 2], valid where each is in the other's
    k nearest)."""
    if distances.shape[0] != distances.shape[1]:
        raise ValueError("mutual kNN requires a square distance matrix")
    member, idx, valid = _knn_membership_parts(distances, k, valid_mask)
    pairs = _pair_list(idx)
    rows, cols = pairs[:, 0].long(), pairs[:, 1].long()
    return pairs, valid.reshape(-1) & member[cols, rows]


def pairs_quantile(distances: torch.Tensor, q: float,
                   valid_mask: Optional[torch.Tensor] = None,
                   low: float = 0.0) -> torch.Tensor:
    """Adjacency [N, M]: entries in the global quantile band [low, q) of
    the valid distances (one quantile over all valid entries, linear
    interpolation, as ``jnp.nanquantile``)."""
    d = _sanitize(distances, valid_mask)
    finite = torch.isfinite(d)
    dq = torch.where(finite, d, torch.full((), float("nan"), dtype=d.dtype,
                                           device=d.device)).reshape(-1)
    q_low = torch.nanquantile(dq, low)
    q_high = torch.nanquantile(dq, q)
    return finite & (d >= q_low) & (d < q_high)


def pairs_radius(distances: torch.Tensor, radius: float,
                 valid_mask: Optional[torch.Tensor] = None,
                 min_dist: float = 0.0) -> torch.Tensor:
    """Adjacency [N, M]: valid entries in the band [min_dist, radius)."""
    d = _sanitize(distances, valid_mask)
    return torch.isfinite(d) & (d >= min_dist) & (d < radius)


def mask_to_pairs(adj: torch.Tensor, max_pairs: int, *,
                  uniform: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``max_pairs`` (i, j) index pairs of an adjacency mask: the
    first in row order, or, with ``uniform`` or ``generator``, a random
    pick, each true entry scored 1 + u for a uniform draw u [N*M] (the
    JAX function's ``key``). Returns (pairs [max_pairs, 2] int32, valid
    [max_pairs]); rows past the true entries are invalid."""
    n, m = adj.shape
    flat = adj.reshape(-1)
    score = flat.float()
    if uniform is not None or generator is not None:
        if uniform is None:
            uniform = draw_uniform(flat.shape, generator, adj.device)
        score = score * (1.0 + uniform.to(adj.device))
    take = min(max_pairs, n * m)
    _, idx = torch.sort(score, descending=True, stable=True)
    idx = idx[:take]
    valid = flat[idx]
    pairs = torch.stack([idx // m, idx % m], 1).int()
    if take < max_pairs:
        pad = max_pairs - take
        pairs = torch.cat([pairs, pairs.new_zeros((pad, 2))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return pairs, valid


def apply_spatial_constraint(distances: torch.Tensor, coords: torch.Tensor,
                             min_spatial: float) -> torch.Tensor:
    """Feature distances made +inf where the pixels' coordinates [N, 2] are
    closer than ``min_spatial``, before any pair selection."""
    c = coords.float()
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return torch.where(d2 < min_spatial ** 2,
                       torch.full((), INF, dtype=distances.dtype,
                                  device=distances.device), distances)


def pairs_with_spatial_constraint(
        distances: torch.Tensor, coords: torch.Tensor,
        strategy: str = "knn", k: int = 8, q: float = 0.1,
        radius: float = 1.0, min_spatial: float = 4.0,
        valid_mask: Optional[torch.Tensor] = None, q_low: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatially close candidates masked out first, then pairs by
    ``strategy`` (knn, mutual_knn, quantile or radius; the last two through
    :func:`mask_to_pairs` with max_pairs = N*k, in row order)."""
    n = distances.shape[0]
    d = apply_spatial_constraint(distances, coords, min_spatial)
    if strategy == "knn":
        return pairs_knn(d, k, valid_mask)
    if strategy == "mutual_knn":
        return pairs_mutual_knn(d, k, valid_mask)
    if strategy in ("quantile", "radius"):
        adj = (pairs_quantile(d, q, valid_mask, low=q_low)
               if strategy == "quantile"
               else pairs_radius(d, radius, valid_mask))
        return mask_to_pairs(adj, max_pairs=n * k)
    raise ValueError(f"unknown pair strategy {strategy!r}")


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


def pairs_mutual_knn_chunked(features: torch.Tensor, k: int,
                             patch_ids: Optional[torch.Tensor] = None,
                             coords: Optional[torch.Tensor] = None,
                             pos_min_spatial: float = 4.0,
                             chunk_size: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual kNN over pooled anchors' features [N, C] as a pair list
    (pairs [N*k', 2] int32, valid), the distances taken one block of at
    most ``chunk_size`` x N rows at a time."""
    knn_idx, valid = mutual_knn_grouped(features, k, patch_ids, coords,
                                        pos_min_spatial, chunk_size)
    return _pair_list(knn_idx), valid.reshape(-1)


__all__ = ["pairs_knn", "pairs_mutual_knn", "pairs_quantile", "pairs_radius",
           "pairs_with_spatial_constraint", "mask_to_pairs",
           "apply_spatial_constraint", "knn_membership",
           "pairs_mutual_knn_chunked", "mutual_knn_grouped"]
