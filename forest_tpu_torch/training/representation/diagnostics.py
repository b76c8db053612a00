"""Training diagnostics computed inside the step (per-step summaries).

Port of ``forest_tpu/training/representation/diagnostics.py``: masked
distribution summaries, the pair-weight distributions under other kernel
temperatures, and the pre-FiLM type-leakage diagnostics (the Frobenius norm
of the cross-covariance and the closed-form ridge R^2 of z_type from the
time-pooled pre-FiLM hidden, lambda 1e-3). All on fixed shapes with masks;
an epoch averages the per-step values.

The ridge solve is ``torch.linalg.solve_ex``, which leaves its error flag on
the device: no host synchronisation on a card.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

TAU_SWEEP: Tuple[float, ...] = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0)


def _nanquantiles(x: torch.Tensor, valid: torch.Tensor,
                  qs: Sequence[float]) -> Tuple[torch.Tensor, ...]:
    """Quantiles (linear interpolation) of ``x[valid]``, NaN where no entry
    is valid, as ``jnp.nanquantile`` of x with NaN outside ``valid``."""
    flat = torch.where(valid, x, torch.full_like(x, float("nan"))).reshape(
        -1)
    return tuple(torch.nanquantile(flat, q) for q in qs)


@torch.no_grad()
def masked_stats(x: torch.Tensor, valid: torch.Tensor,
                 prefix: str) -> Dict[str, torch.Tensor]:
    """``{prefix}_mean / _std / _p05 / _p50 / _p95`` over ``x[valid]``."""
    x = x.float()
    valid = valid.bool().expand(x.shape)
    v = valid.float()
    cnt = torch.clamp(v.sum(), min=1.0)
    mean = (x * v).sum() / cnt
    var = ((x - mean) ** 2 * v).sum() / cnt
    p05, p50, p95 = _nanquantiles(x, valid, (0.05, 0.5, 0.95))
    return {f"{prefix}_mean": mean, f"{prefix}_std": torch.sqrt(var),
            f"{prefix}_p05": p05, f"{prefix}_p50": p50,
            f"{prefix}_p95": p95}


@torch.no_grad()
def tau_sweep_stats(d: torch.Tensor, valid: torch.Tensor, min_w: float,
                    prefix: str, negate: bool,
                    taus: Sequence[float] = TAU_SWEEP
                    ) -> Dict[str, torch.Tensor]:
    """For each tau the weights w = clip(exp(-d / tau), min_w, 1), or
    clip(1 - exp(-d / tau), min_w, 1) with ``negate`` (negatives):
    ``{prefix}_{tau}_mean / _q25 / _q50`` over the valid entries."""
    out: Dict[str, torch.Tensor] = {}
    valid = valid.bool()
    v = valid.float()
    cnt = torch.clamp(v.sum(), min=1.0)
    for tau in taus:
        e = torch.exp(-d.float() / tau)
        w = torch.clamp(1.0 - e if negate else e, min_w, 1.0)
        q25, q50 = _nanquantiles(w, valid, (0.25, 0.5))
        out[f"{prefix}_{tau:g}_mean"] = (w * v).sum() / cnt
        out[f"{prefix}_{tau:g}_q25"] = q25
        out[f"{prefix}_{tau:g}_q50"] = q50
    return out


@torch.no_grad()
def type_leakage_ridge(h_mean: torch.Tensor, z_type: torch.Tensor,
                       valid: torch.Tensor, lam: float = 1e-3
                       ) -> Dict[str, torch.Tensor]:
    """h_mean [N, zp] time-pooled pre-FiLM hidden; z_type [N, zt]
    (stop-gradient); valid [N] -> the cross-covariance's Frobenius norm and
    the ridge R^2 of z_type from h (mean and max over z_type's dims)."""
    v = valid.float()[:, None]
    cnt = torch.clamp(v.sum(), min=2.0)
    h = h_mean.float()
    z = z_type.float()
    h_c = (h - (h * v).sum(0) / cnt) * v
    z_c = (z - (z * v).sum(0) / cnt) * v
    cross = (h_c.t() @ z_c) / (cnt - 1.0)
    frob = torch.sqrt((cross * cross).sum())
    zp = h_c.shape[1]
    a = h_c.t() @ h_c + lam * torch.eye(zp, device=h.device)
    b = h_c.t() @ z_c
    w, _info = torch.linalg.solve_ex(a, b)                     # [zp, zt]
    pred = h_c @ w
    ss_res = ((z_c - pred) ** 2).sum(0)
    ss_tot = torch.clamp((z_c ** 2).sum(0), min=1e-8)
    r2 = 1.0 - ss_res / ss_tot
    return {"leak_cross_cov_frob": frob, "leak_r2_mean": r2.mean(),
            "leak_r2_max": r2.max()}


__all__ = ["TAU_SWEEP", "masked_stats", "tau_sweep_stats",
           "type_leakage_ridge"]
