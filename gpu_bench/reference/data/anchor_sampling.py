# Frozen copy of forest_tpu_torch/data/anchor_sampling.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Anchor pixel sampling: jittered grid + weighted supplement, batched.

Port of ``forest_tpu/data/anchor_sampling.py``:

- :func:`sample_anchors_grid`: a regular stride grid inside an
  ``exclude_border`` margin, its origin shifted by a jitter of up to
  +/- ``jitter_radius`` per sample;
- :func:`sample_anchors_supplement`: ``n`` weighted draws without
  replacement from a weight map (Gumbel top-k);
- :func:`sample_anchors_grid_plus_supplement`: both, the grid anchors
  valid where their weight is positive;
- :func:`resolve_weights`: product of mask maps, then an optional
  ``inverse-frequency`` transform over a values map with an optional
  whitelist;
- :class:`AnchorSampler`: a callable bundling a strategy config.

Anchor counts are fixed by the config; a supplement draw with no positive
weight behind it is flagged invalid. The JAX functions take one sample and
are vmapped by the training step; these take [B, ...] maps.

Randomness: the grid takes its integer jitter [B, 2] and the supplement its
uniform draw [B, H*W]; both are drawn from ``generator`` when not given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from gpu_bench.reference.ops.topk import gumbel_weighted_topk
from gpu_bench.reference.utils.draws import randint


def grid_anchor_count(h: int, w: int, stride: int,
                      exclude_border: int) -> Tuple[int, int]:
    ny = max((h - 2 * exclude_border + stride - 1) // stride, 0)
    nx = max((w - 2 * exclude_border + stride - 1) // stride, 0)
    return ny, nx


def draw_grid_jitter(batch: int, jitter_radius: int,
                     generator: Optional[torch.Generator],
                     device) -> torch.Tensor:
    """Integer (row, col) jitter [B, 2] in [-radius, radius]."""
    return randint(-jitter_radius, jitter_radius + 1, (batch, 2), generator,
                   device)


def sample_anchors_grid(h: int, w: int, jitter: torch.Tensor,
                        stride: int = 16, exclude_border: int = 16
                        ) -> torch.Tensor:
    """jitter [B, 2] -> [B, ny*nx, 2] grid coordinates (row, col), clipped
    into the border margin."""
    ny, nx = grid_anchor_count(h, w, stride, exclude_border)
    dev = jitter.device
    jitter = jitter.long()
    rows = exclude_border + torch.arange(ny, device=dev) * stride \
        + jitter[:, :1]
    cols = exclude_border + torch.arange(nx, device=dev) * stride \
        + jitter[:, 1:]
    rows = rows.clamp(exclude_border, h - 1 - exclude_border)    # [B, ny]
    cols = cols.clamp(exclude_border, w - 1 - exclude_border)    # [B, nx]
    bsz = jitter.shape[0]
    rr = rows[:, :, None].expand(bsz, ny, nx)
    cc = cols[:, None, :].expand(bsz, ny, nx)
    return torch.stack([rr.reshape(bsz, -1), cc.reshape(bsz, -1)], dim=-1)


def resolve_weights(masks: Sequence[torch.Tensor],
                    values: Optional[torch.Tensor] = None,
                    transform: Optional[str] = None,
                    valid_values: Optional[Sequence[float]] = None
                    ) -> torch.Tensor:
    """Product of mask maps [B, H, W]; optional inverse-frequency
    reweighting over a categorical ``values`` map restricted to
    ``valid_values`` (frequencies counted per sample)."""
    w = None
    for m in masks:
        mf = m.float()
        w = mf if w is None else w * mf
    if w is None:
        raise ValueError("at least one mask required")
    if transform == "inverse-frequency":
        if values is None:
            raise ValueError("inverse-frequency needs a values map")
        v = values
        if valid_values is not None:
            whitelist = torch.as_tensor(list(valid_values), dtype=v.dtype,
                                        device=v.device)
            w = w * (v[..., None] == whitelist).any(-1).float()
        bsz = w.shape[0]
        vmax = 4096
        vi = v.long().reshape(bsz, -1).clamp(0, vmax - 1)
        counts = torch.zeros(bsz, vmax, device=w.device).scatter_add_(
            1, vi, w.reshape(bsz, -1))
        freq = counts.gather(1, vi).reshape(w.shape)
        w = torch.where(w > 0, w / freq.clamp(min=1.0), torch.zeros_like(w))
    return w


def sample_anchors_supplement(weights: torch.Tensor, n: int, *,
                              u: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted draw without replacement of ``n`` pixel coords per sample:
    weights [B, H, W] -> (coords [B, n, 2], valid [B, n]). Rows beyond the
    number of positive-weight pixels are invalid."""
    bsz, _, w = weights.shape
    idx, valid = gumbel_weighted_topk(weights.reshape(bsz, -1), n, u=u,
                                      generator=generator)
    return torch.stack([idx // w, idx % w], dim=-1), valid


def sample_anchors_grid_plus_supplement(
        weights: torch.Tensor, stride: int = 16, exclude_border: int = 16,
        jitter_radius: int = 4, n_supplement: int = 104, *,
        jitter: Optional[torch.Tensor] = None,
        supplement_u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The jittered grid plus a weighted supplement: weights [B, H, W] ->
    (coords [B, G + S, 2], valid [B, G + S]); a grid anchor is valid where
    its weight is positive. ``jitter`` [B, 2] and ``supplement_u`` [B, H*W]
    are the raw draws, else drawn from ``generator``."""
    bsz, h, w = weights.shape
    if jitter is None:
        jitter = draw_grid_jitter(bsz, jitter_radius, generator,
                                  weights.device)
    grid = sample_anchors_grid(h, w, jitter.to(weights.device), stride,
                               exclude_border)
    bidx = torch.arange(bsz, device=weights.device)[:, None]
    gvalid = weights[bidx, grid[..., 0], grid[..., 1]] > 0
    supp, svalid = sample_anchors_supplement(
        weights, n_supplement, u=supplement_u, generator=generator)
    return (torch.cat([grid, supp], dim=1),
            torch.cat([gvalid, svalid], dim=1))


@dataclass
class AnchorSamplerConfig:
    strategy: str = "grid-plus-supplement"   # 'grid' | 'grid-plus-supplement'
    stride: int = 16
    exclude_border: int = 16
    jitter_radius: int = 4
    n_supplement: int = 104
    weight_masks: Sequence[str] = field(default_factory=list)
    weight_transform: Optional[str] = None
    weight_values: Optional[str] = None
    valid_values: Optional[Sequence[float]] = None


class AnchorSampler:
    """Callable bundling the strategy; resolves weight maps from a dict of
    named mask / value grids [B, H, W]."""

    def __init__(self, cfg: AnchorSamplerConfig):
        if cfg.strategy not in ("grid", "grid-plus-supplement"):
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        self.cfg = cfg

    def n_anchors(self, h: int, w: int) -> int:
        ny, nx = grid_anchor_count(h, w, self.cfg.stride,
                                   self.cfg.exclude_border)
        n = ny * nx
        if self.cfg.strategy == "grid-plus-supplement":
            n += self.cfg.n_supplement
        return n

    def grid_names(self) -> set:
        """The "group.channel" references this sampler reads."""
        names = set(self.cfg.weight_masks)
        if self.cfg.weight_values:
            names.add(self.cfg.weight_values)
        return names

    def __call__(self, grids: Dict[str, torch.Tensor], batch: int, h: int,
                 w: int, device, *, jitter: Optional[torch.Tensor] = None,
                 supplement_u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (coords [B, A, 2] int64, valid [B, A])."""
        c = self.cfg
        masks = [grids[name] for name in c.weight_masks] or \
            [torch.ones((batch, h, w), device=device)]
        values = grids.get(c.weight_values) if c.weight_values else None
        weights = resolve_weights(masks, values, c.weight_transform,
                                  c.valid_values)
        if c.strategy == "grid-plus-supplement":
            return sample_anchors_grid_plus_supplement(
                weights, c.stride, c.exclude_border, c.jitter_radius,
                c.n_supplement, jitter=jitter, supplement_u=supplement_u,
                generator=generator)
        if jitter is None:
            jitter = draw_grid_jitter(batch, c.jitter_radius, generator,
                                      device)
        grid = sample_anchors_grid(h, w, jitter.to(device), c.stride,
                                   c.exclude_border)
        bidx = torch.arange(batch, device=device)[:, None]
        return grid, weights[bidx, grid[..., 0], grid[..., 1]] > 0


def build_anchor_sampler(spec: Dict) -> AnchorSampler:
    """From a bindings ``sampling-strategy`` YAML entry."""
    if "grid" in spec and "supplement" in spec:
        g = spec["grid"]
        s = spec["supplement"]
        samp = s.get("sampling", {})
        return AnchorSampler(AnchorSamplerConfig(
            strategy="grid-plus-supplement",
            stride=g.get("stride", 16),
            exclude_border=g.get("exclude_border", 16),
            jitter_radius=(g.get("jitter") or {}).get("radius", 0),
            n_supplement=s.get("n", 104),
            weight_masks=samp.get("weight_by", []),
            weight_transform=samp.get("transform"),
            weight_values=samp.get("values"),
            valid_values=samp.get("valid_values")))
    return AnchorSampler(AnchorSamplerConfig(
        strategy="grid",
        stride=spec.get("stride", 16),
        exclude_border=spec.get("exclude_border", 16),
        jitter_radius=(spec.get("jitter") or {}).get("radius", 0)))


__all__ = ["sample_anchors_grid", "sample_anchors_supplement",
           "sample_anchors_grid_plus_supplement", "draw_grid_jitter",
           "resolve_weights", "AnchorSampler", "AnchorSamplerConfig",
           "build_anchor_sampler",
           "grid_anchor_count"]
