"""Temperature (tau) calibration sweeps (port of
``forest_tpu/eval/tau_calibration.py``, numpy only).

Behavioral contract from the reference's epoch-0 tau sweeps
(original:frl/training/representation/step.py:157-159,774-785 and the
check_evt_tau example, SURVEY.md §6.5/§2.8): given positive/negative pair
similarities (or reference distances), evaluate the InfoNCE (or softmax
entropy) across a tau grid so the practitioner can size the temperature to
the observed similarity gap.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


DEFAULT_TAUS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0)


def infonce_tau_sweep(pos_sims: np.ndarray, neg_sims: np.ndarray,
                      taus: Sequence[float] = DEFAULT_TAUS
                      ) -> Dict[float, float]:
    """Mean 1-positive-vs-all InfoNCE loss per tau.

    pos_sims [P]; neg_sims [N] -- pooled similarities (higher = closer).
    """
    pos = np.asarray(pos_sims, np.float64).ravel()
    neg = np.asarray(neg_sims, np.float64).ravel()
    out = {}
    for tau in taus:
        lp = pos / tau                                # [P]
        ln = neg / tau                                # [N]
        m = max(lp.max(initial=0.0), ln.max(initial=0.0))
        neg_mass = np.exp(ln - m).sum()
        # per positive: -log( e^{s+/t} / (e^{s+/t} + sum_neg e^{s-/t}) )
        loss = -(lp - m - np.log(np.exp(lp - m) + neg_mass))
        out[float(tau)] = float(loss.mean()) if loss.size else 0.0
    return out


def entropy_tau_sweep(ref_distances: np.ndarray,
                      taus: Sequence[float] = DEFAULT_TAUS
                      ) -> Dict[float, float]:
    """Mean row entropy of softmax(-d/tau) per tau (the check_evt_tau
    calibration: entropy ~ 0 means tau too small, ~ log(M) too large)."""
    d = np.asarray(ref_distances, np.float64)
    out = {}
    for tau in taus:
        logits = -d / tau
        logits = logits - logits.max(axis=-1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=-1, keepdims=True)
        ent = -(p * np.log(np.maximum(p, 1e-30))).sum(-1)
        out[float(tau)] = float(ent.mean())
    return out


def similarity_gap_report(pos_sims: np.ndarray, neg_sims: np.ndarray,
                          temperature: float) -> Dict[str, float]:
    """The 'Spectral sims' gap / T kernel-sizing diagnostic
    (SURVEY.md §6.5): tau is well-sized when gap/T is O(1)."""
    pos = float(np.mean(pos_sims)) if len(np.atleast_1d(pos_sims)) else 0.0
    neg = float(np.mean(neg_sims)) if len(np.atleast_1d(neg_sims)) else 0.0
    gap = pos - neg
    return {"pos_sim": pos, "neg_sim": neg, "gap": gap,
            "gap_over_T": gap / max(temperature, 1e-9)}


__all__ = ["infonce_tau_sweep", "entropy_tau_sweep",
           "similarity_gap_report", "DEFAULT_TAUS"]
