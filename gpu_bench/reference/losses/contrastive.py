# Frozen copy of forest_tpu_torch/losses/contrastive.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Weighted anchor-grouped InfoNCE over a regular [S, K] pair layout.

Port of ``forest_tpu/losses/contrastive.py`` (``pair_similarity`` and
``contrastive_loss_grouped``): similarities are l2 (-||a-b||^2 / D), cosine
or dot; pair weights act in log space; the loss is the per-anchor
-log(sum_pos w e^{s/t} / sum_all w e^{s/t}), averaged over anchors that have
at least one valid positive. The positive sum shares the all-pairs shift and
an eps sits inside the log, which saturates a hard anchor's loss near
log_all - log(eps) instead of letting it grow without bound.
:func:`contrastive_loss` is the flat form over pair rows grouped by an
anchor id (segment reductions: ``scatter_reduce`` for the maxima,
``index_add_`` for the sums, :func:`segment_logsumexp`); the training step
uses the grouped one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG = -1e30
_LSE_EPS = 1e-8


def pair_similarity(a: torch.Tensor, b: torch.Tensor, kind: str = "l2",
                    eps: float = 1e-8) -> torch.Tensor:
    """Similarity per pair row: a, b are [..., D] -> [...]."""
    a = a.float()
    b = b.float()
    if kind == "l2":
        return -((a - b) ** 2).sum(-1) / a.shape[-1]
    if kind == "cosine":
        na = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + eps)
        nb = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + eps)
        return (na * nb).sum(-1)
    if kind == "dot":
        return (a * b).sum(-1)
    raise ValueError(f"unknown similarity {kind!r}")


def _anchor_mean(per_anchor: torch.Tensor, anchor_ok: torch.Tensor,
                 sim: torch.Tensor, pos_valid: torch.Tensor,
                 neg_valid: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """The loss averaged over the anchors with a valid positive, and the
    aux statistics both forms return."""
    zero = torch.zeros((), device=sim.device)
    denom = torch.clamp(anchor_ok.float().sum(), min=1.0)
    loss = torch.where(anchor_ok, per_anchor, zero).sum() / denom
    return loss, {
        "n_anchors_used": anchor_ok.sum(),
        "mean_pos_sim": (torch.where(pos_valid, sim, zero).sum()
                         / torch.clamp(pos_valid.sum(), min=1)),
        "mean_neg_sim": (torch.where(neg_valid, sim, zero).sum()
                         / torch.clamp(neg_valid.sum(), min=1)),
    }


def contrastive_loss_grouped(z_anchor: torch.Tensor, z_other: torch.Tensor,
                             is_positive: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             pair_valid: Optional[torch.Tensor] = None,
                             similarity: str = "l2",
                             temperature: float = 0.07
                             ) -> Tuple[torch.Tensor, dict]:
    """z_anchor [S, D]; z_other [S, K, D]; is_positive / weights /
    pair_valid [S, K]. Returns (scalar loss, aux dict with
    ``n_anchors_used``, ``mean_pos_sim``, ``mean_neg_sim``)."""
    s, k = z_other.shape[:2]
    dev = z_other.device
    if pair_valid is None:
        pair_valid = torch.ones((s, k), dtype=torch.bool, device=dev)
    if weights is None:
        weights = torch.ones((s, k), device=dev)
    sim = pair_similarity(z_anchor[:, None, :].expand_as(z_other), z_other,
                          similarity)                            # [S, K]
    logw = torch.log(torch.clamp(weights.float(), min=1e-12))
    logits = sim / temperature + logw

    neg = torch.full((), _NEG, device=dev)
    zero = torch.zeros((), device=dev)
    all_max = torch.where(pair_valid, logits, neg).max(dim=1).values
    m_safe = torch.where(all_max > _NEG / 2, all_max, zero)

    def masked_lse(valid):
        # mask BEFORE the exp: the exp of a raw invalid logit can overflow
        # when the shared shift is large-negative, and where() does not
        # keep an inf out of the backward pass
        x = torch.where(valid, logits, neg)
        e = torch.where(valid, torch.exp(x - m_safe[:, None]), zero)
        return torch.log(e.sum(1) + _LSE_EPS) + m_safe, valid.any(1)

    pos_valid = pair_valid & is_positive
    lse_all, has_all = masked_lse(pair_valid)
    lse_pos, has_pos = masked_lse(pos_valid)
    return _anchor_mean(lse_all - lse_pos, has_pos & has_all, sim,
                        pos_valid, pair_valid & ~is_positive)


def _segment_max(x: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment maximum; -inf for an empty segment (as
    ``jax.ops.segment_max``)."""
    out = torch.full((num_segments,), float("-inf"), dtype=x.dtype,
                     device=x.device)
    return out.scatter_reduce(0, ids.long(), x, "amax")


def _segment_sum(x: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    return torch.zeros(num_segments, dtype=x.dtype,
                       device=x.device).index_add(0, ids.long(), x)


def segment_logsumexp(logits: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, valid: torch.Tensor,
                      shift: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-segment logsumexp with the eps inside the log. ``shift``:
    a per-segment maximum to use instead of the segment's own (so the
    positive-subset sum shares the all-pairs shift). Returns (lse [S],
    has_any [S] bool)."""
    neg = torch.full((), _NEG, dtype=logits.dtype, device=logits.device)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    logits = torch.where(valid, logits, neg)
    seg_max = _segment_max(logits, segment_ids, num_segments) \
        if shift is None else shift
    has_any = _segment_sum(valid.float(), segment_ids, num_segments) > 0
    seg_max_safe = torch.where(seg_max > _NEG / 2, seg_max, zero)
    shifted = torch.exp(torch.where(
        valid, logits - seg_max_safe[segment_ids.long()], neg))
    shifted = torch.where(valid, shifted, zero)
    seg_sum = _segment_sum(shifted, segment_ids, num_segments)
    return torch.log(seg_sum + _LSE_EPS) + seg_max_safe, has_any


def contrastive_loss(z_anchor: torch.Tensor, z_other: torch.Tensor,
                     anchor_ids: torch.Tensor, is_positive: torch.Tensor,
                     num_anchors: int,
                     weights: Optional[torch.Tensor] = None,
                     pair_valid: Optional[torch.Tensor] = None,
                     similarity: str = "l2", temperature: float = 0.07
                     ) -> Tuple[torch.Tensor, dict]:
    """Weighted anchor-grouped InfoNCE over flat pair rows: z_anchor,
    z_other [P, D]; anchor_ids [P] in [0, num_anchors); is_positive,
    weights, pair_valid [P]. Returns (scalar loss, aux dict) as
    :func:`contrastive_loss_grouped`."""
    p = z_anchor.shape[0]
    dev = z_anchor.device
    if pair_valid is None:
        pair_valid = torch.ones((p,), dtype=torch.bool, device=dev)
    if weights is None:
        weights = torch.ones((p,), device=dev)
    sim = pair_similarity(z_anchor, z_other, similarity)
    logits = sim / temperature + torch.log(
        torch.clamp(weights.float(), min=1e-12))
    pos_valid = pair_valid & is_positive
    all_max = _segment_max(
        torch.where(pair_valid, logits, torch.full((), _NEG, device=dev)),
        anchor_ids, num_anchors)
    lse_all, has_all = segment_logsumexp(logits, anchor_ids, num_anchors,
                                         pair_valid, shift=all_max)
    lse_pos, has_pos = segment_logsumexp(logits, anchor_ids, num_anchors,
                                         pos_valid, shift=all_max)
    return _anchor_mean(lse_all - lse_pos, has_pos & has_all, sim,
                        pos_valid, pair_valid & ~is_positive)


__all__ = ["contrastive_loss", "contrastive_loss_grouped",
           "pair_similarity", "segment_logsumexp"]
