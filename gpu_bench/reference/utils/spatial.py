# Frozen copy of forest_tpu_torch/utils/spatial.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Extraction and pair sampling at pixel coordinates, batched over B.

Port of ``forest_tpu/utils/spatial.py`` (channel-last; pair lists have a
fixed size with validity masks). The JAX functions take one sample and are
vmapped by their caller; these take the batch dimension directly:

- :func:`extract_at_locations`: [B, H, W, C] + [B, N, 2] -> [B, N, C];
- :func:`extract_temporal_at_locations`: [B, T, H, W, C] + [B, N, 2] ->
  [B, N, T, C];
- :func:`spatial_knn_pairs`: the k nearest fixed offsets applied to every
  anchor, bounds- and mask-checked;
- :func:`spatial_negative_slots`: one shared pool of random valid pixels per
  sample, from which every anchor picks ``n_per_anchor`` members inside its
  distance ring, returned as slot indices into the pool;
  :func:`spatial_negative_pairs` returns the same picks as coordinates.

Randomness: :func:`spatial_negative_slots` (and
:func:`spatial_negative_pairs`) takes its two uniform draws
(``pool_u`` [B, H*W], ``pick_u`` [B, N, P]) or draws them from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpu_bench.reference.ops.topk import gumbel_weighted_topk
from gpu_bench.reference.utils.draws import uniform


def _batch_index(coords: torch.Tensor):
    coords = coords.long()
    bidx = torch.arange(coords.shape[0], device=coords.device)[:, None]
    return bidx, coords[..., 0], coords[..., 1]


def extract_at_locations(grid: torch.Tensor,
                         coords: torch.Tensor) -> torch.Tensor:
    """grid [B, H, W, C], coords [B, N, 2] (row, col) -> [B, N, C]."""
    bidx, r, c = _batch_index(coords)
    return grid[bidx, r, c]


def extract_temporal_at_locations(grid: torch.Tensor,
                                  coords: torch.Tensor) -> torch.Tensor:
    """grid [B, T, H, W, C], coords [B, N, 2] -> [B, N, T, C]."""
    bidx, r, c = _batch_index(coords)
    return grid.permute(0, 2, 3, 1, 4)[bidx, r, c]


def _knn_offsets(k: int, max_radius: int) -> np.ndarray:
    """The k closest nonzero (dr, dc) offsets within max_radius."""
    r = max_radius
    dr, dc = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    off = np.stack([dr.ravel(), dc.ravel()], 1)
    d = np.sqrt((off ** 2).sum(1))
    keep = (d > 0) & (d <= max_radius)
    off, d = off[keep], d[keep]
    order = np.argsort(d, kind="stable")
    return off[order[:min(k, len(order))]].astype(np.int64)


def spatial_knn_pairs(anchor_coords: torch.Tensor, mask: torch.Tensor,
                      k: int = 4, max_radius: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """anchor_coords [B, N, 2], mask [B, H, W] -> (neighbor_coords
    [B, N, k', 2] clipped into the image, valid [B, N, k'])."""
    h, w = mask.shape[-2:]
    offsets = torch.as_tensor(_knn_offsets(k, max_radius),
                              device=anchor_coords.device)
    nbr = anchor_coords.long()[:, :, None, :] + offsets[None, None]
    in_bounds = ((nbr[..., 0] >= 0) & (nbr[..., 0] < h)
                 & (nbr[..., 1] >= 0) & (nbr[..., 1] < w))
    rr = nbr[..., 0].clamp(0, h - 1)
    cc = nbr[..., 1].clamp(0, w - 1)
    bidx = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    valid = (mask[bidx, rr, cc] > 0) & in_bounds
    return torch.stack([rr, cc], -1), valid


def spatial_negative_slots(anchor_coords: torch.Tensor, mask: torch.Tensor,
                           min_distance: float = 16.0,
                           max_distance: Optional[float] = None,
                           n_per_anchor: int = 4, pool_size: int = 512, *,
                           pool_u: Optional[torch.Tensor] = None,
                           pick_u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Ring-sampled negatives as shared-pool slot references.

    anchor_coords [B, N, 2], mask [B, H, W]. Returns (pool_coords
    [B, P, 2], pool_ok [B, P], sel [B, N, n_per_anchor] slot ids into the
    pool, sel_ok [B, N, n_per_anchor]); P = min(pool_size, H*W)."""
    bsz, n = anchor_coords.shape[:2]
    h, w = mask.shape[-2:]
    p = min(pool_size, h * w)
    dev = mask.device
    idx, pool_ok = gumbel_weighted_topk(
        (mask.reshape(bsz, -1) > 0).float(), p, u=pool_u,
        generator=generator)
    pool = torch.stack([idx // w, idx % w], -1)                  # [B, P, 2]
    d = torch.sqrt(((pool[:, None].float()
                     - anchor_coords[:, :, None].float()) ** 2).sum(-1))
    ok = pool_ok[:, None, :] & (d >= min_distance)               # [B, N, P]
    if max_distance is not None:
        ok = ok & (d <= max_distance)
    if pick_u is None:
        pick_u = uniform((bsz, n, p), generator, dev)
    prio = torch.where(ok, pick_u.to(dev),
                       torch.full((), float("-inf"), device=dev))
    pv, sel = torch.topk(prio, n_per_anchor, dim=-1)
    return pool, pool_ok, sel, torch.isfinite(pv)


def spatial_negative_pairs(anchor_coords: torch.Tensor, mask: torch.Tensor,
                           min_distance: float = 16.0,
                           max_distance: Optional[float] = None,
                           n_per_anchor: int = 4, pool_size: int = 512, *,
                           pool_u: Optional[torch.Tensor] = None,
                           pick_u: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """:func:`spatial_negative_slots` with the picks as coordinates, the
    same draws: (anchor_idx [B, N*k], neighbour coords [B, N*k, 2], valid
    [B, N*k]), k = ``n_per_anchor``."""
    bsz, n = anchor_coords.shape[:2]
    pool, _, sel, sel_ok = spatial_negative_slots(
        anchor_coords, mask, min_distance, max_distance, n_per_anchor,
        pool_size, pool_u=pool_u, pick_u=pick_u, generator=generator)
    bidx = torch.arange(bsz, device=pool.device)[:, None, None]
    picked = pool[bidx, sel]                             # [B, N, k, 2]
    anchor_idx = torch.arange(n, device=pool.device)[:, None].expand(
        n, n_per_anchor).reshape(1, -1).expand(bsz, -1)
    return (anchor_idx, picked.reshape(bsz, -1, 2),
            sel_ok.reshape(bsz, -1))


__all__ = ["extract_at_locations", "extract_temporal_at_locations",
           "spatial_knn_pairs", "spatial_negative_pairs",
           "spatial_negative_slots"]
