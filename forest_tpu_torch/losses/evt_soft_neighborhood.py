"""EVT-confusion diffusion metric and the soft neighbourhood loss over it.

Port of ``forest_tpu/losses/evt_soft_neighborhood.py``:

- the metric, built once on the host with numpy: a LANDFIRE EVT confusion
  CSV, summary rows and columns dropped; codes kept by regional pixel count
  (``min_count``) and by confusion row samples (``min_confusion_samples``);
  symmetrised, optionally Laplace-smoothed, row-normalised to a stochastic
  P (an empty row becomes uniform); P^k diffusion; optionally a binary
  threshold with re-normalisation -> similarity S (the loss's reference
  distance is 1 - S); inverse-frequency anchor weights
  clip(median_freq / freq, max_weight);
- the loss: per anchor the KL between softmax(-d_ref / tau_ref) and
  softmax(-d_learned / tau_learned) over pairs of OTHER anchors with a
  DIFFERENT code, rows weighted by the inverse code frequency. An anchor
  whose code is unknown has weight 0 and a fully masked row.
"""
from __future__ import annotations

import csv as _csv
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from forest_tpu_torch.losses.soft_neighborhood import pairwise_sq_distances

_SUMMARY_TOKENS = {"total", "sum", "all", "overall", "user", "producer",
                   "users", "producers", "accuracy", "commission",
                   "omission", ""}


def _load_confusion_csv(path) -> Tuple[np.ndarray, list]:
    """A labelled square confusion CSV -> (matrix [K, K] float64, codes),
    summary rows and columns dropped, rows and columns aligned on the codes
    both carry, in row order."""
    with open(path, newline="") as f:
        rows = list(_csv.reader(f))
    header = rows[0][1:]

    def keep(lbl: str) -> bool:
        s = str(lbl).strip().lower()
        if s in _SUMMARY_TOKENS:
            return False
        try:
            int(float(s))
            return True
        except ValueError:
            return False

    col_ok = [i for i, h in enumerate(header) if keep(h)]
    codes_c = [int(float(header[i])) for i in col_ok]
    mat_rows, codes_r = [], []
    for r in rows[1:]:
        if not r or not keep(r[0]):
            continue
        codes_r.append(int(float(r[0])))
        mat_rows.append([float(r[1 + i] or 0) for i in col_ok])
    m = np.asarray(mat_rows, np.float64)
    common = [c for c in codes_r if c in codes_c]
    ri = [codes_r.index(c) for c in common]
    ci = [codes_c.index(c) for c in common]
    return m[np.ix_(ri, ci)], common


class EvtDiffusionMetric:
    """``similarity`` [K, K] float32, ``codes`` [K] int64, ``code_to_idx``
    and ``freq_weights`` [K] float32, from a confusion CSV and per-code
    pixel counts."""

    def __init__(self, confusion_csv, code_counts: Dict,
                 min_count: int = 100, min_confusion_samples: int = 30,
                 diffusion_steps: int = 2, laplace_smoothing: float = 0.0,
                 binary_threshold: float = 0.0, max_weight: float = 10.0):
        conf, codes = _load_confusion_csv(Path(confusion_csv))
        int_counts = {int(k): float(v) for k, v in code_counts.items()}
        keep = [i for i, c in enumerate(codes)
                if int_counts.get(c, 0.0) >= min_count]
        conf = conf[np.ix_(keep, keep)]
        codes = [codes[i] for i in keep]
        if min_confusion_samples > 0:
            rs = conf.sum(axis=1)
            keep2 = [i for i in range(len(codes))
                     if rs[i] >= min_confusion_samples]
            conf = conf[np.ix_(keep2, keep2)]
            codes = [codes[i] for i in keep2]
        if len(codes) < 2:
            raise ValueError(
                "fewer than 2 EVT codes survive filtering -- lower the "
                "thresholds or check the stats coverage")

        c_sym = (conf + conf.T) / 2.0
        if laplace_smoothing > 0.0:
            c_sym = c_sym + laplace_smoothing
        rs = c_sym.sum(axis=1, keepdims=True)
        uniform = np.full_like(c_sym, 1.0 / c_sym.shape[0])
        p = np.where(rs > 0, c_sym / np.where(rs > 0, rs, 1.0), uniform)
        pk = np.linalg.matrix_power(p, diffusion_steps)
        if binary_threshold > 0.0:
            pb = (pk > binary_threshold).astype(float)
            np.fill_diagonal(pb, 0.0)
            rsb = pb.sum(axis=1, keepdims=True)
            pk = np.where(rsb > 0, pb / np.where(rsb > 0, rsb, 1.0), uniform)

        self.similarity = pk.astype(np.float32)
        self.codes = np.asarray(codes, np.int64)
        self.code_to_idx = {c: i for i, c in enumerate(codes)}

        counts = np.array([int_counts.get(c, 0.0) for c in codes])
        total = counts.sum()
        freqs = counts / total if total > 0 else \
            np.ones_like(counts) / len(counts)
        pos = freqs[freqs > 0]
        med = float(np.median(pos)) if pos.size else 1.0
        w = np.where(freqs > 0, med / np.maximum(freqs, 1e-12), 0.0)
        self.freq_weights = np.clip(w, 0.0, max_weight).astype(np.float32)

    @property
    def n_codes(self) -> int:
        return len(self.codes)

    def lookup(self, evt_codes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw codes [N] -> (metric index [N] int32, valid [N], weight
        [N] float32), on the host."""
        codes = np.asarray(evt_codes)
        idx = np.array([self.code_to_idx.get(int(c), 0) for c in codes],
                       np.int32)
        valid = np.array([int(c) in self.code_to_idx for c in codes], bool)
        w = np.where(valid, self.freq_weights[idx], 0.0).astype(np.float32)
        return idx, valid, w


def evt_soft_neighborhood_loss(
        embeddings: torch.Tensor, metric_idx: torch.Tensor,
        anchor_valid: torch.Tensor, anchor_weights: torch.Tensor,
        similarity: torch.Tensor, evt_codes: torch.Tensor,
        tau_ref: float = 0.5, tau_learned: float = 0.5,
        min_valid_anchors: int = 4
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """embeddings [N, D]; metric_idx / anchor_valid / anchor_weights [N] (as
    :meth:`EvtDiffusionMetric.lookup` gives them); ``similarity`` the
    metric's [K, K]; ``evt_codes`` [N] raw codes (for the same-code
    exclusion). -> (loss, stats)."""
    n = embeddings.shape[0]
    dev = embeddings.device
    valid = anchor_valid.bool()
    sim_t = similarity.to(device=dev, dtype=torch.float32)
    sim = sim_t[metric_idx.long()][:, metric_idx.long()]          # [N, N]
    vv = valid[:, None] & valid[None, :]
    zero = torch.zeros((), device=dev)
    d_ref = 1.0 - torch.where(vv, sim, zero)

    d_learned = torch.sqrt(pairwise_sq_distances(embeddings.float())
                           + 1e-12)
    same_code = evt_codes[:, None] == evt_codes[None, :]
    mask = vv & ~torch.eye(n, dtype=torch.bool, device=dev) & ~same_code

    neg = torch.full((), -1e9, device=dev)
    logits_ref = torch.where(mask, -d_ref / tau_ref, neg)
    logits_lrn = torch.where(mask, -d_learned / tau_learned, neg)
    row_active = mask.sum(1) >= 2

    log_p = torch.log_softmax(logits_ref, dim=1)
    log_q = torch.log_softmax(logits_lrn, dim=1)
    p = torch.exp(log_p)
    kl = torch.where(mask, p * (log_p - log_q), zero).sum(1)
    kl = torch.where(row_active, kl, zero)

    rw = anchor_weights.float() * row_active.float() * valid.float()
    total_w = rw.sum()
    n_valid = valid.sum()
    enough = (n_valid >= min_valid_anchors) & (total_w > 0)
    loss = torch.where(enough, (rw * kl).sum()
                       / torch.clamp(total_w, min=1e-12), zero)
    with torch.no_grad():
        q = torch.exp(log_q)
        act = row_active.float()
        denom = torch.clamp(act.sum(), min=1.0)
        stats = {
            "n_anchors_in": torch.tensor(n),
            "n_anchors_valid": n_valid,
            "n_rows_active": row_active.sum(),
            "mean_kl": loss.detach(),
            "mean_entropy_ref": (-torch.where(mask, p * log_p, zero).sum(1)
                                 * act).sum() / denom,
            "mean_entropy_learned": (-torch.where(mask, q * log_q, zero)
                                     .sum(1) * act).sum() / denom,
        }
    return loss, stats


def write_synthetic_confusion_csv(path, codes, seed: int = 0) -> Path:
    """A labelled confusion CSV over ``codes`` in LANDFIRE's layout, with the
    summary row and column the loader drops (``Total``): off-diagonal counts
    in [5, 40), diagonal in [105, 240), drawn from ``seed``. For tests and
    the chip smoke, which have no real confusion table."""
    path = Path(path)
    rng = np.random.default_rng(seed)
    k = len(codes)
    conf = rng.integers(5, 40, size=(k, k)).astype(float)
    conf += np.diag(rng.integers(100, 200, size=k).astype(float))
    lines = [",".join([""] + [str(c) for c in codes] + ["Total"])]
    for c, row in zip(codes, conf):
        lines.append(",".join([str(c)] + [f"{v:g}" for v in row]
                              + [f"{row.sum():g}"]))
    lines.append(",".join(["Total"] + [f"{v:g}" for v in conf.sum(0)]
                          + [f"{conf.sum():g}"]))
    path.write_text("\n".join(lines) + "\n")
    return path


__all__ = ["EvtDiffusionMetric", "evt_soft_neighborhood_loss",
           "write_synthetic_confusion_csv"]
