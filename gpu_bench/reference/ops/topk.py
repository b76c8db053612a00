# Frozen copy of forest_tpu_torch/ops/topk.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Exact top-k in ``jax.lax.top_k``'s order, and Gumbel-top-k weighted
sampling without replacement on it.

Port of ``forest_tpu/ops/topk.py``. :func:`top_k` returns the k largest
entries of the last axis in descending order, the lowest index first among
equal values: ``lax.top_k``'s order, which the JAX losses rely on wherever
-inf or +inf fill padded slots (phase pairs, the phase neighbourhood
builder). ``torch.topk`` does not promise that tie order, so this sorts
with ``torch.sort(stable=True)``. :func:`topk_maybe_approx` is exact at
every size. Adding i.i.d. Gumbel noise to the
log-weights and taking the top k draws k indices without replacement with
probability proportional to weight. The JAX package switches to an
approximate TPU top-k above 4096 entries; here ``torch.topk`` is exact at
every size. The last axis is the sampled one, any leading axes are batch.

Randomness: the Gumbel noise is ``-log(-log(u))`` of a uniform draw ``u`` of
the weights' shape, given by the caller or drawn from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpu_bench.reference.utils.draws import uniform


def top_k(scores: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (values [..., k], indices [..., k] int64) of the k largest entries
    of the last axis: descending, and the lowest index first among ties
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_maybe_approx(scores: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`top_k`, at every size. The JAX version switches to
    ``lax.approx_max_k`` above ``exact_below`` entries; that call is exact
    (``lax.top_k``'s indices) everywhere but on a TPU, so the TPU's
    approximate path is the only place the two packages can differ."""
    return top_k(scores, k)


def gumbel_weighted_topk(weights: torch.Tensor, k: int, *,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sample of ``k`` indices of the last axis, without
    replacement.

    ``weights`` [..., M]; entries <= 0 are never drawn. ``u`` uniform [0, 1)
    of the same shape (drawn from ``generator`` when None). Returns
    ``(idx [..., k] int64, valid [..., k] bool)``; ``valid`` marks draws
    backed by positive weight, and the index of an invalid draw is
    arbitrary."""
    w = weights.float()
    if u is None:
        u = uniform(w.shape, generator, w.device)
    u = u.to(w.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    scores = torch.where(w > 0,
                         torch.log(torch.clamp(w, min=1e-20)) + gumbel,
                         torch.full_like(w, float("-inf")))
    vals, idx = torch.topk(scores, k, dim=-1)
    return idx, torch.isfinite(vals)


__all__ = ["top_k", "topk_maybe_approx", "gumbel_weighted_topk"]
