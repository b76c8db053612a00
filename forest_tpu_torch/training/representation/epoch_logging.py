"""Per-epoch diagnostic text block.

Port of ``forest_tpu/training/representation/epoch_logging.py``, copied
whole: every loss component, pair counts, gate / FiLM / similarity
summaries, the distributions and tau sweeps of the diagnostics, and the
loader wait / step split. Metric keys double as checkpoint-monitor names
(``train/...``, ``val/...``).
"""
from __future__ import annotations

from typing import Dict


_SECTIONS = [
    ("losses", ["loss_total", "loss_spatial_infonce",
                "loss_spectral_infonce", "loss_vicreg_type",
                "loss_vicreg_phase", "loss_phase_neighborhood",
                "loss_phase_spread", "loss_recovery_disc",
                "loss_type_leakage", "loss_evt"]),
    ("phase", ["phase_loss_self", "phase_loss_cross", "phase_pairs_valid",
               "spread_frac_satisfied", "film_gamma_mean",
               "film_beta_mean"]),
    ("similarities", ["spatial_pos_sim", "spatial_neg_sim",
                      "spectral_pos_sim", "spectral_neg_sim",
                      "spectral_n_anchors"]),
    ("model", ["gate_mean", "grad_norm", "skipped", "samples_skipped",
               "n_anchors_valid"]),
    ("pipeline", ["n_steps", "epoch_time_s", "wait_s", "step_s"]),
]


def _fmt(v: float) -> str:
    if abs(v) >= 1000 or (v != 0 and abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:.4f}"


_DIST_PREFIXES = [
    ("gate", "diag_gate"),
    ("spatial pos weights", "diag_pos_weight"),
    ("spatial neg weights", "diag_neg_weight"),
    ("spatial pos sims", "diag_pos_sim"),
    ("spatial neg sims", "diag_neg_sim"),
    ("spatial pos spec dists", "diag_pos_spec_dist"),
    ("spatial neg spec dists", "diag_neg_spec_dist"),
    ("spectral pos sims", "diag_spectral_pos_sim"),
]

_TAU_TABLES = [
    ("spatial pos weight tau sweep", "diag_tau_pos"),
    ("spatial neg weight tau sweep", "diag_tau_neg"),
    ("spectral neg weight tau sweep", "diag_tau_spectral_neg"),
]


def _dist_line(label: str, p: str, m: Dict[str, float]) -> str:
    return (f"    {label:<24s} mean={m[p + '_mean']:.4f}"
            f"±{m[p + '_std']:.4f}  p05={m[p + '_p05']:.4f}"
            f"  p50={m[p + '_p50']:.4f}  p95={m[p + '_p95']:.4f}")


def format_epoch_block(epoch: int, train: Dict[str, float],
                       val: Dict[str, float] | None = None,
                       lr: float | None = None) -> str:
    lines = [f"===== epoch {epoch}"
             + (f"  lr={lr:.2e}" if lr is not None else "") + " ====="]
    for title, keys in _SECTIONS:
        present = [k for k in keys if k in train]
        if not present:
            continue
        lines.append(f"  [{title}]")
        for k in present:
            row = f"    {k:<26s} train {_fmt(train[k])}"
            if val and k in val:
                row += f"   val {_fmt(val[k])}"
            lines.append(row)

    # the diagnostics: distribution summaries, leakage ridge, tau sweeps
    dist_rows = [(lbl, p) for lbl, p in _DIST_PREFIXES
                 if f"{p}_mean" in train]
    if dist_rows:
        lines.append("  [distributions]")
        lines.extend(_dist_line(lbl, p, train) for lbl, p in dist_rows)
    if "leak_r2_mean" in train:
        lines.append(
            f"  [type leakage]  pre-FiLM ridge R2 mean="
            f"{train['leak_r2_mean']:.4f} max={train['leak_r2_max']:.4f}"
            f"  cross-cov frob={train['leak_cross_cov_frob']:.4f}")
    if epoch == 0:  # tau sweeps print on epoch 0 only
        for title, p in _TAU_TABLES:
            taus = sorted({float(k[len(p) + 1:].rsplit("_", 1)[0])
                           for k in train if k.startswith(p + "_")})
            if not taus:
                continue
            lines.append(f"  [{title}]  (epoch 0)")
            lines.append(f"    {'tau':>6}  {'mean':>8}  {'q25':>8}  "
                         f"{'q50':>8}")
            for t in taus:
                lines.append(
                    f"    {t:>6.1f}  {train[f'{p}_{t:g}_mean']:>8.3f}  "
                    f"{train[f'{p}_{t:g}_q25']:>8.3f}  "
                    f"{train[f'{p}_{t:g}_q50']:>8.3f}")

    known = {k for _, ks in _SECTIONS for k in ks}
    known |= {k for k in train if k.startswith(("diag_", "leak_"))}
    extra = sorted(set(train) - known)
    if extra:
        lines.append("  [other] " + "  ".join(
            f"{k}={_fmt(train[k])}" for k in extra))
    return "\n".join(lines)


def checkpoint_metrics(train: Dict[str, float],
                       val: Dict[str, float] | None) -> Dict[str, float]:
    """Flatten to monitor-name keys (train/... and val/...)."""
    out = {f"train/{k}": v for k, v in train.items()}
    if val:
        out.update({f"val/{k}": v for k, v in val.items()})
    return out


__all__ = ["format_epoch_block", "checkpoint_metrics"]
