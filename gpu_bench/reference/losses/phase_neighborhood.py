# Frozen copy of forest_tpu_torch/losses/phase_neighborhood.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Phase neighbourhood: ysfc-aligned trajectory matching losses.

Port of ``forest_tpu/losses/phase_neighborhood.py``:

- alignment of a pixel pair on the ysfc values both share: per value ONE
  representative timestep per pixel, the one in the longest recovery
  sequence (a sequence restarts at t = 0 or wherever ysfc decreases), the
  most recent on ties;
- aligned self-distance and cross-pixel distance matrices over the shared
  values (:func:`build_phase_neighborhood_batch`);
- :func:`phase_neighborhood_loss`: self-similarity KL (embedding
  self-distances at i match spectral self-distances at j) + cross-pixel KL;
- :func:`compute_phase_spread_ranking`: soft-margin ranking, the more
  spectrally dynamic pixel of a pair must have the larger phase spread;
- :func:`type_local_spectral_demean`: the spectral features demeaned by the
  mean over each anchor's kNN in rank-reduced z_type space.

All shapes are fixed: the value axis V is the static ``num_classes``, the
aligned axis M equals T (a pixel has at most T distinct values), and
invalid pairs keep all-False masks, which the mask-based KL ignores.

One builder, grouped by sample, in place of the JAX package's flat and
sample-grouped ones (whose one-hot products and ``mnb`` / ``mnsp`` layouts
keep the TPU off its serial gathers): the pair -> anchor hop is a gather
here, and the output is pairs-leading [S*P, M, M]. Aligned distances are
sums of squared differences (the ``mnsp`` form, the one the JAX train step
runs), which keep a self pair's zero distances at exactly zero.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from gpu_bench.reference.losses.soft_neighborhood import \
    soft_neighborhood_matching_loss
from gpu_bench.reference.ops.topk import top_k, topk_maybe_approx


def seq_lengths_per_t(ysfc: torch.Tensor) -> torch.Tensor:
    """[N, T] -> [N, T]: the length of the recovery sequence that holds each
    timestep (a new sequence at t = 0 or where ysfc decreases)."""
    t = ysfc.shape[-1]
    y = ysfc.float()
    prev = torch.cat([y[:, :1] + 1.0, y[:, :-1]], dim=1)
    seq_id = torch.cumsum((y < prev).long(), dim=1) - 1           # [N, T]
    ar = torch.arange(t, device=y.device)
    lengths = (seq_id[:, :, None] == ar).sum(1).float()           # [N, S]
    # a series that starts with NaN has seq_id -1 before its first
    # sequence; like jnp.take_along_axis, index -1 reads the last slot
    return torch.gather(lengths, 1, seq_id % t)


def _presence_and_best_t(ysfc: torch.Tensor, num_classes: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ysfc [N, T] -> presence [N, V] bool; best_t [N, V] int64, the
    representative timestep of each (pixel, value): the longest sequence,
    the most recent on ties (0 where the value is absent)."""
    t = ysfc.shape[-1]
    ok = (ysfc >= 0) & (ysfc < num_classes)
    y = torch.where(ok, ysfc, torch.zeros_like(ysfc)).long().clamp(
        0, num_classes - 1)
    ind = (y[:, None, :] == torch.arange(num_classes, device=y.device)[
        None, :, None]) & ok[:, None, :]                          # [N, V, T]
    presence = ind.any(2)
    sl = seq_lengths_per_t(ysfc)
    score = sl * (t + 1) + torch.arange(t, dtype=torch.float32,
                                        device=y.device)[None, :]
    masked = torch.where(ind, score[:, None, :],
                         torch.full((), float("-inf"), device=y.device))
    return presence, torch.argmax(masked, dim=2)


def build_phase_neighborhood_batch(
        spectral_features: torch.Tensor, phase_embeddings: torch.Tensor,
        ysfc: torch.Tensor, pairs: torch.Tensor,
        pair_valid: Optional[torch.Tensor] = None, min_overlap: int = 3,
        num_classes: int = 64) -> Dict[str, torch.Tensor]:
    """spectral_features [S, A, T, C]; phase_embeddings [S, A, T, D]; ysfc
    [S, A, T]; pairs [S, P, 2] (anchor indices local to each sample);
    pair_valid [S, P]. Returns the aligned distances ``d_*`` [S*P, M, M]
    (M = T), ``mask_self`` / ``mask_cross`` [S*P, M, M], ``valid_pair_mask``
    [S*P], and ``pair_index`` [S*P, 2], the pairs offset into the flat
    [S*A] anchor space."""
    s, a, t, c_dim = spectral_features.shape
    d_dim = phase_embeddings.shape[-1]
    m = t
    n = s * a
    dev = spectral_features.device
    presence, best_t = _presence_and_best_t(ysfc.reshape(n, t), num_classes)

    # Per-pixel compressed tables: slot j of a pixel holds its j-th smallest
    # present value (then absent values, ascending).
    neg_inf = torch.full((), float("-inf"), device=dev)
    varange = torch.arange(num_classes, dtype=torch.float32, device=dev)
    _, vals_px = top_k(torch.where(presence, -varange, neg_inf), m)
    best_t_c = torch.gather(best_t, 1, vals_px)                   # [N, M]
    sel = torch.cat([spectral_features.reshape(n, t, c_dim),
                     phase_embeddings.reshape(n, t, d_dim)], dim=-1)
    sel = torch.gather(sel, 1, best_t_c[:, :, None].expand(
        n, m, c_dim + d_dim))                                     # [N, M, C+D]
    # position of value v inside its pixel's compressed list
    pos_px = torch.cumsum(presence.long(), dim=1) - 1             # [N, V]

    offs = (torch.arange(s, device=dev) * a)[:, None]
    idx_i = (pairs[..., 0].long() + offs).reshape(-1)             # [B]
    idx_j = (pairs[..., 1].long() + offs).reshape(-1)
    shared = presence[idx_i] & presence[idx_j]                    # [B, V]
    k_per_pair = shared.sum(1)
    valid_pair = k_per_pair >= min_overlap
    if pair_valid is not None:
        valid_pair = valid_pair & pair_valid.reshape(-1).bool()

    # shared values in ascending order: slot j holds the j-th smallest
    _, inv_v = top_k(torch.where(shared, -varange, neg_inf), m)   # [B, M]
    slot_ok = torch.arange(m, device=dev)[None, :] < k_per_pair[:, None]

    def align(idx):
        pos = torch.gather(pos_px[idx], 1, inv_v).clamp(0, m - 1)  # [B, M]
        g = sel[idx[:, None], pos]                              # [B, M, C+D]
        return torch.where(slot_ok[..., None], g, torch.zeros_like(g))

    gi, gj = align(idx_i), align(idx_j)
    ai_spec, ai_phase = gi[..., :c_dim], gi[..., c_dim:]
    aj_spec, aj_phase = gj[..., :c_dim], gj[..., c_dim:]

    def cdist(x, y):
        d2 = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
        return torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)      # [B, M, M]

    mask_cross = (slot_ok[:, :, None] & slot_ok[:, None, :]
                  & valid_pair[:, None, None])
    mask_self = mask_cross & ~torch.eye(m, dtype=torch.bool,
                                        device=dev)[None]
    return {
        "d_ref_self": cdist(aj_spec, aj_spec),
        "d_learned_self": cdist(ai_phase, ai_phase),
        "d_learned_self_j": cdist(aj_phase, aj_phase),
        "mask_self": mask_self,
        "d_ref_cross": cdist(ai_spec, aj_spec),
        "d_learned_cross": cdist(ai_phase, aj_phase),
        "mask_cross": mask_cross,
        "valid_pair_mask": valid_pair,
        "pair_index": torch.stack([idx_i, idx_j], dim=1),
    }


def phase_neighborhood_loss(
        batch: Dict[str, torch.Tensor],
        pair_weights: Optional[torch.Tensor] = None,
        tau_ref: float = 0.1, tau_learned: float = 0.1,
        min_valid_per_row: int = 2, self_similarity_weight: float = 1.0,
        cross_pixel_weight: float = 1.0
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-similarity + cross-pixel KL over the aligned matrices of
    :func:`build_phase_neighborhood_batch`; ``pair_weights`` [S*P]."""
    vp = batch["valid_pair_mask"]
    b = vp.shape[0]
    w = pair_weights.reshape(b) if pair_weights is not None else \
        torch.ones(b, device=vp.device)
    w = w * vp.to(w.dtype)
    loss_self, stats_self = soft_neighborhood_matching_loss(
        batch["d_ref_self"], batch["d_learned_self"], batch["mask_self"],
        tau_ref, tau_learned, w, min_valid_per_row)
    loss_cross, stats_cross = soft_neighborhood_matching_loss(
        batch["d_ref_cross"], batch["d_learned_cross"], batch["mask_cross"],
        tau_ref, tau_learned, w, min_valid_per_row)
    loss = (self_similarity_weight * loss_self
            + cross_pixel_weight * loss_cross)
    stats = {"n_pairs_input": torch.tensor(b),
             "n_pairs_sufficient_overlap": vp.sum(),
             "loss_self": loss_self.detach(),
             "loss_cross": loss_cross.detach()}
    stats.update({f"self_{k}": v for k, v in stats_self.items()})
    stats.update({f"cross_{k}": v for k, v in stats_cross.items()})
    return loss, stats


def compute_phase_spread_ranking(
        batch: Dict[str, torch.Tensor], pair_indices: torch.Tensor,
        dynamism_ref: torch.Tensor, margin: float = 0.1, delta: float = 0.5
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dynamism-ranked trajectory-spread soft-margin loss over the valid
    pairs of ``batch``; ``pair_indices`` [S*P, 2] into ``dynamism_ref``
    [S*A] (the builder's ``pair_index``)."""
    d_i = batch["d_learned_self"]
    d_j = batch["d_learned_self_j"]
    mf = batch["mask_self"].to(d_i.dtype)
    vp = batch["valid_pair_mask"]
    n_valid = torch.clamp(mf.sum((1, 2)), min=1.0)
    spread_i = (d_i * mf).sum((1, 2)) / n_valid
    spread_j = (d_j * mf).sum((1, 2)) / n_valid

    ref_diff = (dynamism_ref[pair_indices[:, 0]]
                - dynamism_ref[pair_indices[:, 1]]).reshape(vp.shape)
    act = vp.to(d_i.dtype)
    i_more = (ref_diff > delta).to(d_i.dtype) * act
    j_more = (ref_diff < -delta).to(d_i.dtype) * act
    loss_i = torch.nn.functional.softplus(spread_j - spread_i + margin) \
        * i_more
    loss_j = torch.nn.functional.softplus(spread_i - spread_j + margin) \
        * j_more
    n_con = torch.clamp(i_more.sum() + j_more.sum(), min=1.0)
    # normalised over ALL valid pairs, not the constrained subset
    n_act = torch.clamp(act.sum(), min=1.0)
    loss = (loss_i.sum() + loss_j.sum()) / n_act
    with torch.no_grad():
        satisfied = (i_more * (spread_i > spread_j + margin)
                     + j_more * (spread_j > spread_i + margin))
        stats = {
            "n_pairs": vp.sum(),
            "n_constrained_i": i_more.sum().long(),
            "n_constrained_j": j_more.sum().long(),
            "frac_satisfied": satisfied.sum() / n_con,
            "mean_spread_i": (spread_i * act).sum() / n_act,
            "mean_spread_j": (spread_j * act).sum() / n_act,
            "mean_ref_diff": (ref_diff.abs() * act).sum() / n_act,
        }
    return loss, stats


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products in full float32 (no TF32) on a card."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@torch.no_grad()
def type_local_spectral_demean(z_type: torch.Tensor, spec: torch.Tensor,
                               valid: torch.Tensor, pca_dim: int,
                               knn_k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral features demeaned by a type-local baseline: rank-``pca_dim``
    PCA of the (stop-gradient) z_type over the valid rows, whitened scores,
    kNN by their inner product, and the neighbours' mean of the time-pooled
    spectrum subtracted from every timestep.

    The top eigenbasis of ``Z_c^T Z_c`` (``torch.linalg.eigh``, eigenvalues
    floored at 1e-12), with the scores divided by the singular values, gives
    the same Gram ``U U^T`` as the original's ``pca_lowrank`` U. Invalid rows
    count in no mean and are never neighbours; their own baseline is
    meaningless (masked downstream).

    The [D, D] Gram's eigenbasis is found on the host: cuSOLVER's ``eigh``
    on a card waits for the host ten times a call (its workspace and error
    flag), LAPACK there after one copy of the Gram waits once; the basis
    goes back by a copy from pinned memory that does not wait.

    z_type [N, D], spec [N, T, C], valid [N] -> (spec_demeaned [N, T, C],
    baseline [N, C])."""
    n, d = z_type.shape
    v = valid.float()[:, None]
    cnt = torch.clamp(v.sum(), min=1.0)
    z = z_type.float()
    mu = (z * v).sum(0, keepdim=True) / cnt
    zc = (z - mu) * v                                         # [N, D]
    k = min(pca_dim, d)
    with full_float32():
        gram = zc.t() @ zc                                    # [D, D]
        if gram.is_cuda:
            evals, evecs = (
                t.pin_memory().to(gram.device, non_blocking=True)
                for t in torch.linalg.eigh(gram.cpu()))       # ascending
        else:
            evals, evecs = torch.linalg.eigh(gram)
        lam = torch.sqrt(torch.clamp(evals[d - k:], min=1e-12))
        u = (zc @ evecs[:, d - k:]) / lam[None, :]
        sim = u @ u.t()                                       # [N, N]
    neg = torch.full((), -1e30, device=sim.device)
    sim = torch.where(torch.eye(n, dtype=torch.bool, device=sim.device),
                      neg, sim)
    sim = torch.where(valid.bool()[None, :], sim, neg)
    kk = min(knn_k, n - 1)
    _, idx = topk_maybe_approx(sim, kk)                       # [N, kk]
    s_mean = spec.mean(1)                                     # [N, C]
    nb_v = valid.float()[idx]                                 # [N, kk]
    denom = torch.clamp(nb_v.sum(1, keepdim=True), min=1.0)
    s_hat = (s_mean[idx] * nb_v[..., None]).sum(1) / denom
    return spec - s_hat[:, None, :], s_hat


__all__ = ["build_phase_neighborhood_batch", "phase_neighborhood_loss",
           "compute_phase_spread_ranking", "seq_lengths_per_t",
           "type_local_spectral_demean"]
