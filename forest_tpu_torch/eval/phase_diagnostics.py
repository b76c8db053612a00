"""Phase diagnostics: per-EVT FiLM/variance heatmaps, recovery curves,
ysfc histograms, and the EVT contingency-table merger.

Port of ``forest_tpu/eval/phase_diagnostics.py``:

- phase_evt_diagnostics (the reference's phase_evt_diagnostics.py):
  per-EVT FiLM gamma and z_phase temporal-variance heatmaps;
- phase_recovery_curves (phase_recovery_curves.py): per-EVT recovery
  (embedding response vs ysfc) curves;
- ysfc_evt_histograms (ysfc_evt_histograms.py): data-level ysfc
  distributions per EVT code;
- combine_evt_contingency_tables (combine_evt_contingency_tables.py): sum
  aligned cells of two labelled confusion CSVs (NE + SE LANDFIRE tables).

The samples are gathered on ``device``: each patch's type forward (K1 on
a card), its FiLM phase forward at strided anchors and the ysfc / EVT
gathers run there, and each patch comes to the host in one copy. The
reports are the JAX package's numpy code. Figures are drawn through
``utils.log.pyplot``: where matplotlib does not import, each is skipped
with a log line, and every CSV and ``summary.json`` is written all the
same.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_tpu_torch.eval.frozen import (batch_to_device,
                                          make_phase_target_fn, to_host)
from forest_tpu_torch.eval.linear_probe import strided_coords
from forest_tpu_torch.utils import spatial as sp
from forest_tpu_torch.utils.log import pyplot


def _channel_grid(fb, batch, source: str) -> torch.Tensor:
    """``group.channel`` of a device batch -> [B, ..., H, W, 1]."""
    g, c = source.split(".")
    return batch[g][..., fb.bindings.dataset[g].channel_index(c)][..., None]


def _patch_samples(encode_type_fn, encode_phase_fn, fb, dataset, i: int,
                   evt_source: str, ysfc_source: str, stride: int, device,
                   targets_fn=None, with_type: bool = False
                   ) -> Dict[str, np.ndarray]:
    """One patch's anchors (a strided grid inside a border of 2): z_phase
    [A, T, zp], gamma [A, zp], ysfc [A, T], evt [A], and with_type's
    z_type [A, zt], targets_fn's target [A, T, C] (NaN where masked)."""
    batch = batch_to_device(dataset.load_batch([i]), device)
    zt = encode_type_fn(batch)
    coords = strided_coords(zt.shape[1], zt.shape[2], stride, halo=2,
                            device=zt.device)
    cb = coords.expand(1, -1, -1)
    zp, gamma = encode_phase_fn(batch, coords)
    out = {"z_phase": zp[0], "gamma": gamma[0],
           "ysfc": sp.extract_temporal_at_locations(
               _channel_grid(fb, batch, ysfc_source), cb)[0, ..., 0],
           "evt": sp.extract_at_locations(
               _channel_grid(fb, batch, evt_source), cb)[0, :, 0]}
    if with_type:
        out["z_type"] = sp.extract_at_locations(zt, cb)[0]
    if targets_fn is not None:
        ta, tm = targets_fn(batch, coords)
        out["target"] = torch.where(tm, ta.float(), float("nan"))[0]
    return to_host(out)


def collect_phase_samples(encode_type_fn, encode_phase_fn, fb, dataset,
                          evt_source: str, ysfc_source: str,
                          n_patches: int = 8, stride: int = 4,
                          device="cuda"):
    """Gather (z_phase [N, T, zp], gamma [N, zp], ysfc [N, T], evt [N])
    at strided anchors across patches."""
    s = [_patch_samples(encode_type_fn, encode_phase_fn, fb, dataset, i,
                        evt_source, ysfc_source, stride, device)
         for i in range(min(n_patches, len(dataset)))]
    return tuple(np.concatenate([p[k] for p in s])
                 for k in ("z_phase", "gamma", "ysfc", "evt"))


def phase_evt_diagnostics(z_phase, gamma, evt, out_path: str | Path,
                          max_codes: int = 12) -> Optional[Path]:
    """Per-EVT heatmaps: mean FiLM gamma and z_phase temporal variance."""
    codes, counts = np.unique(evt[np.isfinite(evt)], return_counts=True)
    codes = codes[np.argsort(-counts)][:max_codes]
    g_rows, v_rows = [], []
    for c in codes:
        sel = evt == c
        g_rows.append(gamma[sel].mean(0))
        v_rows.append(z_phase[sel].var(axis=1).mean(0))
    out_path = Path(out_path)
    plt = pyplot(out_path.name)
    if plt is None:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(10, 0.5 * len(codes) + 2))
    for ax, rows, title in ((axes[0], g_rows, "FiLM gamma (mean)"),
                            (axes[1], v_rows,
                             "z_phase temporal variance")):
        im = ax.imshow(np.asarray(rows), aspect="auto", cmap="viridis")
        ax.set_yticks(range(len(codes)))
        ax.set_yticklabels([f"{int(c)}" for c in codes])
        ax.set_xlabel("dim")
        ax.set_title(title)
        plt.colorbar(im, ax=ax, fraction=0.046)
    axes[0].set_ylabel("EVT code")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def phase_recovery_curves(z_phase, ysfc, evt, out_path: str | Path,
                          max_codes: int = 6,
                          ysfc_bins: Sequence[float] = (0, 2, 5, 10, 20,
                                                        40)
                          ) -> Optional[Path]:
    """Per-EVT recovery: ||z_phase|| response binned by ysfc."""
    codes, counts = np.unique(evt[np.isfinite(evt)], return_counts=True)
    codes = codes[np.argsort(-counts)][:max_codes]
    mag = np.linalg.norm(z_phase, axis=-1)   # [N, T]
    centers = [(ysfc_bins[i] + ysfc_bins[i + 1]) / 2
               for i in range(len(ysfc_bins) - 1)]
    curves = []
    for c in codes:
        sel = evt == c
        y = ysfc[sel].ravel()
        m = mag[sel].ravel()
        ok = np.isfinite(y) & np.isfinite(m)
        means = []
        for i in range(len(ysfc_bins) - 1):
            b = ok & (y >= ysfc_bins[i]) & (y < ysfc_bins[i + 1])
            means.append(m[b].mean() if b.any() else np.nan)
        curves.append((c, means))
    out_path = Path(out_path)
    plt = pyplot(out_path.name)
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    for c, means in curves:
        ax.plot(centers, means, marker="o", label=f"EVT {int(c)}")
    ax.set_xlabel("years since fast change")
    ax.set_ylabel("||z_phase||")
    ax.set_title("phase recovery curves per EVT")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def ysfc_evt_histograms(ysfc, evt, out_path: str | Path,
                        max_codes: int = 8) -> Optional[Path]:
    codes, counts = np.unique(evt[np.isfinite(evt)], return_counts=True)
    codes = codes[np.argsort(-counts)][:max_codes]
    values = []
    for c in codes:
        v = ysfc[evt == c].ravel()
        values.append(v[np.isfinite(v)])
    out_path = Path(out_path)
    plt = pyplot(out_path.name)
    if plt is None:
        return None
    n = len(codes)
    fig, axes = plt.subplots((n + 3) // 4, 4,
                             figsize=(12, 2.4 * ((n + 3) // 4)),
                             squeeze=False)
    for i, (c, v) in enumerate(zip(codes, values)):
        ax = axes[i // 4][i % 4]
        ax.hist(v, bins=20)
        ax.set_title(f"EVT {int(c)} (n={v.size})", fontsize=9)
    for j in range(n, axes.size):
        axes[j // 4][j % 4].axis("off")
    fig.suptitle("ysfc distribution per EVT")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Reference-depth per-EVT report families
# ---------------------------------------------------------------------------

# Post-disturbance recovery bins (phase_recovery_curves.py:65-75; the
# ysfc-histogram tool shares them).
YSFC_BINS = [(0, 1), (1, 2), (2, 3), (3, 5), (5, 8), (8, 13), (13, 20),
             (20, 31)]
YSFC_BIN_LABELS = ["0", "1", "2", "3-4", "5-7", "8-12", "13-19", "20-30"]


def _evt_groups(evt: np.ndarray):
    """-> (codes [C] int, inv [N], counts [C]): dense per-EVT grouping so
    the accumulators below are single vectorized scatter-adds instead of
    the reference's per-class Python loops."""
    ok = np.isfinite(evt)
    codes, inv = np.unique(evt[ok].astype(np.int64), return_inverse=True)
    return codes, inv, np.bincount(inv, minlength=len(codes)), ok


def _scatter_rows(inv: np.ndarray, values: np.ndarray,
                  n_groups: int) -> np.ndarray:
    """Sum [N, D] rows into [C, D] by group id (np.add.at)."""
    out = np.zeros((n_groups, values.shape[-1]), np.float64)
    np.add.at(out, inv, np.asarray(values, np.float64))
    return out


def _label(code: int, names: Optional[Dict[int, str]]) -> str:
    name = (names or {}).get(int(code), f"EVT_{int(code)}")
    return f"{int(code)}: {name[:35]}" if names else f"EVT_{int(code)}"


def _write_csv(path: Path, rows: List[Dict]) -> None:
    if not rows:
        path.write_text("")
        return
    fields = list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _heatmap(matrix: np.ndarray, row_labels: List[str],
             col_labels: List[str], title: str, out_path: Path,
             cmap: str = "viridis", center: Optional[float] = None,
             ) -> Optional[Path]:
    """Labelled, annotated heatmap (reference plot_heatmap,
    phase_evt_diagnostics.py:345-399; matplotlib-only, no seaborn)."""
    plt = pyplot(Path(out_path).name)
    if plt is None:
        return None
    m = np.asarray(matrix, np.float64)
    n_rows, n_cols = m.shape
    fig, ax = plt.subplots(figsize=(max(8, n_cols * 0.9),
                                    max(4, n_rows * 0.5)))
    kwargs = {}
    if center is not None:
        lim = float(np.nanmax(np.abs(m - center))) or 1.0
        kwargs = {"vmin": center - lim, "vmax": center + lim}
    im = ax.imshow(m, aspect="auto", cmap=cmap,
                   interpolation="nearest", **kwargs)
    if n_rows <= 30 and n_cols <= 20:  # reference's annotate rule
        for i in range(n_rows):
            for j in range(n_cols):
                ax.text(j, i, f"{m[i, j]:.2f}", ha="center", va="center",
                        fontsize=6,
                        color="white" if im.norm(m[i, j]) < 0.5 else
                        "black")
    ax.set_xticks(range(n_cols))
    ax.set_xticklabels(col_labels, rotation=45, ha="right", fontsize=8)
    ax.set_yticks(range(n_rows))
    ax.set_yticklabels([r[:46] for r in row_labels], fontsize=8)
    ax.set_title(title)
    plt.colorbar(im, ax=ax, fraction=0.03)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _gamma_ranking(agg, codes, n_pix, evt_names, zp_dim, out_path: Path
                   ) -> None:
    """Sorted barh of every observed EVT's mean gamma with the global-mean
    line."""
    plt = pyplot(out_path.name)
    if plt is None:
        return
    c = len(codes)
    order = np.argsort(agg)
    gmean = float(agg.mean())
    fig, ax = plt.subplots(figsize=(10, max(5, c * 0.28)))
    ax.barh(range(c), agg[order],
            color=["#d73027" if v >= gmean else "#4575b4"
                   for v in agg[order]], edgecolor="white", linewidth=0.4)
    ax.axvline(gmean, color="black", linewidth=1.0, linestyle="--",
               label=f"mean={gmean:.3f}")
    ax.set_yticks(range(c))
    ax.set_yticklabels(
        [f"{_label(codes[i], evt_names)}  (n={n_pix[i]:,})"
         for i in order], fontsize=7)
    ax.set_xlabel(f"Mean FiLM gamma (averaged over z_phase channels "
                  f"0-{zp_dim - 1})")
    ax.set_title("FiLM gamma ranking by EVT class\n"
                 "red = above mean | blue = below mean | dashed = "
                 "global mean")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def evt_phase_report(z_phase: np.ndarray, gamma: np.ndarray,
                     evt: np.ndarray, out_dir: str | Path,
                     top_k: int = 20,
                     evt_names: Optional[Dict[int, str]] = None,
                     probe_pred: Optional[np.ndarray] = None,
                     probe_target: Optional[np.ndarray] = None,
                     probe_evt: Optional[np.ndarray] = None,
                     target_names: Optional[List[str]] = None) -> Dict:
    """The full phase_evt_diagnostics artifact family
    (the reference's phase_evt_diagnostics.py:450-637): gamma_by_evt.csv,
    temporal_frac_by_evt.csv, gamma_heatmap.png (column z-scores, top-K
    EVTs), gamma_ranking.png (sorted barh with the global-mean line),
    temporal_frac_heatmap.png, optional probe_r2_by_evt.csv +
    probe_r2_heatmap.png, summary.json.

    z_phase [N, T, zp] / gamma [N, zp] are PIXEL-level; probe_pred /
    probe_target [M, C] with probe_evt [M] are (pixel x timestep)-level.
    Temporal fraction is the reference's variance decomposition
    within / (within + between) per channel (:199-215).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    zp_dim = z_phase.shape[-1]
    ch_names = [f"ch_{i}" for i in range(zp_dim)]
    codes, inv, n_pix, ok = _evt_groups(evt)
    g = gamma[ok]
    z = z_phase[ok]
    c = len(codes)
    mean_g = _scatter_rows(inv, g, c) / n_pix[:, None]
    std_g = np.sqrt(np.maximum(
        _scatter_rows(inv, g ** 2, c) / n_pix[:, None] - mean_g ** 2, 0))
    # temporal variance decomposition per pixel, then per EVT
    pix_mean = z.mean(axis=1)                       # [N, zp]
    pix_var = z.var(axis=1)                         # [N, zp]
    within = _scatter_rows(inv, pix_var, c) / n_pix[:, None]
    mom = _scatter_rows(inv, pix_mean, c) / n_pix[:, None]
    between = np.maximum(
        _scatter_rows(inv, pix_mean ** 2, c) / n_pix[:, None] - mom ** 2,
        0)
    frac = within / np.maximum(within + between, 1e-12)

    rows_g, rows_f = [], []
    for i, e in enumerate(codes):
        base = {"evt_code": int(e),
                "evt_name": (evt_names or {}).get(int(e), f"EVT_{int(e)}"),
                "n_pixels": int(n_pix[i])}
        rg = dict(base, gamma_mean_agg=float(mean_g[i].mean()))
        rg.update({f"gamma_mean_{n}": float(v)
                   for n, v in zip(ch_names, mean_g[i])})
        rg.update({f"gamma_std_{n}": float(v)
                   for n, v in zip(ch_names, std_g[i])})
        rows_g.append(rg)
        rf = dict(base, temporal_frac_agg=float(frac[i].mean()))
        rf.update({f"frac_{n}": float(v)
                   for n, v in zip(ch_names, frac[i])})
        rows_f.append(rf)
    _write_csv(out_dir / "gamma_by_evt.csv", rows_g)
    _write_csv(out_dir / "temporal_frac_by_evt.csv", rows_f)

    top = np.argsort(-n_pix)[:top_k]
    row_labels = [f"{_label(codes[i], evt_names)}  (n={n_pix[i]:,})"
                  for i in top]
    # gamma heatmap: column-wise z-scores (reference :531-540)
    gm = mean_g[top]
    col_mu, col_sd = gm.mean(0), np.maximum(gm.std(0), 1e-9)
    _heatmap((gm - col_mu) / col_sd, row_labels, ch_names,
             "FiLM gamma by EVT (column z-scores)",
             out_dir / "gamma_heatmap.png", cmap="RdBu_r", center=0.0)
    _heatmap(frac[top], row_labels, ch_names,
             "z_phase temporal variance fraction by EVT",
             out_dir / "temporal_frac_heatmap.png", cmap="viridis")

    # gamma ranking barh: ALL observed EVTs, sorted, global-mean line
    agg = mean_g.mean(1)
    gmean = float(agg.mean())
    _gamma_ranking(agg, codes, n_pix, evt_names, zp_dim,
                   out_dir / "gamma_ranking.png")

    summary = {"n_evt_classes": int(c),
               "n_pixels_total": int(n_pix.sum()),
               "d_phase": int(zp_dim),
               "top_evt_codes": [int(codes[i]) for i in top],
               "global_gamma_mean": gmean}

    if probe_pred is not None and probe_target is not None \
            and probe_evt is not None:
        pcodes, pinv, n_obs, pok = _evt_groups(probe_evt)
        pr, tg = probe_pred[pok], probe_target[pok]
        pc = len(pcodes)
        # Masked observations arrive as NaN targets
        # (collect_phase_samples_full); accumulate per-class per-channel
        # over the FINITE entries only, like the probe fit itself does.
        fin = np.isfinite(tg) & np.isfinite(pr)
        ssres = _scatter_rows(pinv, np.where(fin, (pr - tg) ** 2, 0.0), pc)
        tgz = np.where(fin, tg, 0.0)
        s_t = _scatter_rows(pinv, tgz, pc)
        s_t2 = _scatter_rows(pinv, tgz ** 2, pc)
        n_fin = np.maximum(_scatter_rows(pinv, fin.astype(np.float64), pc),
                           1.0)
        sstot = np.maximum(s_t2 - s_t ** 2 / n_fin, 1e-12)
        r2 = 1.0 - ssres / sstot
        tnames = target_names or [f"t{i}" for i in range(pr.shape[-1])]
        rows_r = []
        for i, e in enumerate(pcodes):
            row = {"evt_code": int(e),
                   "evt_name": (evt_names or {}).get(int(e),
                                                     f"EVT_{int(e)}"),
                   "n_obs": int(n_obs[i]),
                   "r2_mean": float(r2[i].mean())}
            row.update({f"r2_{n}": float(v)
                        for n, v in zip(tnames, r2[i])})
            rows_r.append(row)
        _write_csv(out_dir / "probe_r2_by_evt.csv", rows_r)
        ptop = np.argsort(-n_obs)[:top_k]
        _heatmap(np.clip(r2[ptop], -1, 1),
                 [f"{_label(pcodes[i], evt_names)}  (n={n_obs[i]:,})"
                  for i in ptop], tnames,
                 "Phase probe R^2 by EVT (normalized space)",
                 out_dir / "probe_r2_heatmap.png", cmap="RdBu_r",
                 center=0.0)
        summary["probe_r2_global_mean"] = float(r2.mean())

    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    return summary


def _recovery_figure(evt, ysfc, pred, obs, top, top_counts, evt_names,
                     min_bin_samples: int, png_path: Path) -> Optional[Path]:
    """A 4-column grid of predicted-NBR box plots per EVT over the ysfc
    bins with the observed-NBR median overlaid."""
    plt = pyplot(png_path.name)
    if plt is None:
        return None
    ncols = 4
    nrows = max(-(-len(top) // ncols), 1)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(ncols * 4.5, nrows * 3.5),
                             squeeze=False)
    axes_list = list(axes.flat)
    if pred.size:
        p5, p95 = np.percentile(pred, [2, 98])
        pad = (p95 - p5) * 0.1
        y_lo, y_hi = p5 - pad, p95 + pad
    else:
        y_lo, y_hi = -3, 3
    for ax, code in zip(axes_list, top):
        sel = evt == code
        name = _label(code, evt_names)
        if not sel.any():
            ax.text(0.5, 0.5, "no data", ha="center", va="center",
                    transform=ax.transAxes, fontsize=9)
            ax.set_title(name, fontsize=7)
            continue
        yv, pv, ov = ysfc[sel], pred[sel], obs[sel]
        box_data, obs_med, positions = [], [], []
        for b_idx, (lo, hi) in enumerate(YSFC_BINS):
            b = (yv >= lo) & (yv < hi)
            if int(b.sum()) >= min_bin_samples:
                box_data.append(pv[b])
                obs_med.append(float(np.median(ov[b])))
                positions.append(b_idx)
        if not positions:
            ax.text(0.5, 0.5, "insufficient data", ha="center",
                    va="center", transform=ax.transAxes, fontsize=9)
            ax.set_title(name, fontsize=7)
            continue
        ax.boxplot(box_data, positions=positions, widths=0.55,
                   patch_artist=True,
                   boxprops=dict(facecolor="#5b9bd5", alpha=0.7,
                                 linewidth=0.8),
                   medianprops=dict(color="navy", linewidth=1.5),
                   flierprops=dict(marker=".", markersize=1.5,
                                   alpha=0.3))
        ax.plot(positions, obs_med, "o--", color="#e07b2a",
                linewidth=1.0, markersize=3.5, label="obs median",
                zorder=5)
        ax.axhline(0, color="grey", linewidth=0.6, linestyle=":",
                   alpha=0.7)
        ax.set_xlim(-0.6, len(YSFC_BINS) - 0.4)
        ax.set_ylim(y_lo, y_hi)
        ax.set_xticks(range(len(YSFC_BINS)))
        ax.set_xticklabels(YSFC_BIN_LABELS, rotation=45, ha="right",
                           fontsize=6)
        ax.set_title(f"{name}\n(n={top_counts[int(code)]:,})",
                     fontsize=7, pad=2)
        ax.set_xlabel("ysfc (years)", fontsize=6)
        ax.set_ylabel("Predicted NBR (z-score)", fontsize=6)
        ax.legend(fontsize=5, loc="upper left", framealpha=0.5)
    for ax in axes_list[len(top):]:
        ax.axis("off")
    fig.suptitle("Post-disturbance recovery: predicted NBR vs years "
                 "since fire/change\nblue boxes = predicted NBR | "
                 "orange = observed median", fontsize=9, y=1.01)
    fig.tight_layout()
    fig.savefig(png_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return png_path


def recovery_report(evt: np.ndarray, ysfc: np.ndarray,
                    pred_nbr: np.ndarray, obs_nbr: np.ndarray,
                    out_dir: str | Path, top_k: int = 20,
                    evt_names: Optional[Dict[int, str]] = None,
                    min_bin_samples: int = 5
                    ) -> Tuple[Path, Optional[Path]]:
    """The phase_recovery_curves artifact family (the reference's
    phase_recovery_curves.py:251-418): nbr_by_ysfc_by_evt.csv (per-EVT
    per-bin quartiles) and recovery_curves.png.

    Inputs are flat (pixel x timestep) observations [M]."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = (np.isfinite(evt) & np.isfinite(ysfc) & np.isfinite(pred_nbr)
          & np.isfinite(obs_nbr) & (ysfc >= 0)
          & (ysfc < YSFC_BINS[-1][1]))
    evt, ysfc = evt[ok].astype(np.int64), ysfc[ok]
    pred, obs = pred_nbr[ok], obs_nbr[ok]
    codes, counts = np.unique(evt, return_counts=True)
    top = codes[np.argsort(-counts)][:top_k]
    top_counts = {int(c): int(n) for c, n in zip(codes, counts)}

    rows = []
    for code in top:
        sel = evt == code
        yv, pv, ov = ysfc[sel], pred[sel], obs[sel]
        for (lo, hi), label in zip(YSFC_BINS, YSFC_BIN_LABELS):
            b = (yv >= lo) & (yv < hi)
            n = int(b.sum())
            if n == 0:
                continue
            rows.append({
                "evt_code": int(code),
                "evt_name": (evt_names or {}).get(int(code),
                                                  f"EVT_{int(code)}"),
                "ysfc_bin": label, "n_samples": n,
                "pred_nbr_q25": float(np.percentile(pv[b], 25)),
                "pred_nbr_median": float(np.median(pv[b])),
                "pred_nbr_q75": float(np.percentile(pv[b], 75)),
                "obs_nbr_median": float(np.median(ov[b]))})
    csv_path = out_dir / "nbr_by_ysfc_by_evt.csv"
    _write_csv(csv_path, rows)
    return csv_path, _recovery_figure(
        evt, ysfc, pred, obs, top, top_counts, evt_names, min_bin_samples,
        out_dir / "recovery_curves.png")


def _ysfc_figure(evt, ysfc, top, top_n, evt_names, max_ysfc: float,
                 png_path: Path) -> Optional[Path]:
    """A 4x5 grid of KDE density panels for the top-K EVT classes."""
    plt = pyplot(png_path.name)
    if plt is None:
        return None
    fig, axes = plt.subplots(4, 5, figsize=(14, 10))
    axes_list = list(axes.flat)
    x_grid = np.linspace(0, max_ysfc, 500)
    for idx, (code, total) in enumerate(zip(top, top_n)):
        ax = axes_list[idx]
        vals = ysfc[evt == code]
        xg = x_grid  # per-panel: the fallback must not degrade siblings
        try:
            from scipy.stats import gaussian_kde
            density = gaussian_kde(vals)(xg)
        except Exception:  # singular (constant values) or no scipy
            density, edges = np.histogram(vals, bins=20,
                                          range=(0, max_ysfc),
                                          density=True)
            xg = (edges[:-1] + edges[1:]) / 2
        ax.fill_between(xg, density, alpha=0.6, color="steelblue")
        ax.plot(xg, density, color="steelblue", linewidth=0.8)
        ax.set_xlim(0, max_ysfc)
        ax.set_ylim(bottom=0)
        ax.tick_params(axis="both", labelsize=6)
        ax.set_title(f"{_label(code, evt_names)}\n(n={total:,} obs)",
                     fontsize=7, pad=2)
        ax.set_xlabel("ysfc (years)", fontsize=6)
        ax.set_ylabel("Density", fontsize=6)
    for ax in axes_list[len(top):]:
        ax.axis("off")
    fig.suptitle("ysfc distribution by EVT class | top EVT classes by "
                 "observation count (KDE)", fontsize=9, y=1.01)
    fig.tight_layout()
    fig.savefig(png_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return png_path


def ysfc_report(evt: np.ndarray, ysfc: np.ndarray, out_dir: str | Path,
                top_k: int = 20, max_ysfc: float = 31.0,
                evt_names: Optional[Dict[int, str]] = None
                ) -> Tuple[Path, Optional[Path]]:
    """The ysfc_evt_histograms artifact family (the reference's
    ysfc_evt_histograms.py:155-256): ysfc_by_evt.csv (per-bin counts,
    per-year densities, fractions) and ysfc_histograms.png."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = (np.isfinite(evt) & np.isfinite(ysfc) & (ysfc >= 0)
          & (ysfc <= max_ysfc))
    evt, ysfc = evt[ok].astype(np.int64), ysfc[ok]
    codes, counts = np.unique(evt, return_counts=True)
    order = np.argsort(-counts)[:top_k]
    top, top_n = codes[order], counts[order]

    rows = []
    for code, total in zip(top, top_n):
        vals = ysfc[evt == code]
        for (lo, hi), label in zip(YSFC_BINS, YSFC_BIN_LABELS):
            if lo >= max_ysfc:
                break
            count = int(((vals >= lo) & (vals < hi)).sum())
            rows.append({
                "evt_code": int(code),
                "evt_name": (evt_names or {}).get(int(code),
                                                  f"EVT_{int(code)}"),
                "bin_label": label, "bin_lo": lo, "bin_hi": hi,
                "bin_width": hi - lo, "count": count,
                "density_per_year": count / (hi - lo),
                "total_count": int(total),
                "fraction": count / total if total else 0.0,
                "mean_ysfc": float(vals.mean()),
                "median_ysfc": float(np.median(vals))})
    csv_path = out_dir / "ysfc_by_evt.csv"
    _write_csv(csv_path, rows)
    return csv_path, _ysfc_figure(evt, ysfc, top, top_n, evt_names,
                                  max_ysfc, out_dir / "ysfc_histograms.png")


def combine_evt_contingency_tables(csv_a: str | Path, csv_b: str | Path,
                                   out_csv: str | Path) -> Path:
    """Sum aligned cells of two labeled square confusion CSVs."""
    def load(p):
        with open(p, newline="") as f:
            rows = list(csv.reader(f))
        cols = rows[0][1:]
        table = {}
        for r in rows[1:]:
            if not r or not r[0]:
                continue
            table[r[0]] = {c: float(v or 0)
                           for c, v in zip(cols, r[1:])}
        return table

    a, b = load(csv_a), load(csv_b)
    row_labels = sorted(set(a) | set(b),
                        key=lambda s: (len(s), s))
    col_labels = sorted({c for t in (a, b) for r in t.values()
                         for c in r}, key=lambda s: (len(s), s))
    out_csv = Path(out_csv)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + col_labels)
        for r in row_labels:
            vals = [a.get(r, {}).get(c, 0.0) + b.get(r, {}).get(c, 0.0)
                    for c in col_labels]
            w.writerow([r] + vals)
    return out_csv


def collect_phase_samples_full(encode_type_fn, encode_phase_fn, fb,
                               dataset, evt_source: str,
                               ysfc_source: str,
                               target_feature: Optional[str] = None,
                               n_patches: int = 8, stride: int = 4,
                               device="cuda"):
    """Like :func:`collect_phase_samples` but ALSO returns the z_type
    anchors and (when ``target_feature`` is given) the temporal targets,
    so the probe-dependent report families (recovery curves, per-EVT
    probe R^2) can run without a second pass over the data."""
    targets_fn = (make_phase_target_fn(fb, target_feature)
                  if target_feature else None)
    s = [_patch_samples(encode_type_fn, encode_phase_fn, fb, dataset, i,
                        evt_source, ysfc_source, stride, device,
                        targets_fn=targets_fn, with_type=True)
         for i in range(min(n_patches, len(dataset)))]
    out = {k: np.concatenate([p[k] for p in s])
           for k in ("z_type", "z_phase", "gamma", "ysfc", "evt")}
    out["target"] = (np.concatenate([p["target"] for p in s])
                     if targets_fn is not None else None)
    return out


def _resolve_phase_target(bindings, phase_feature: str) -> str:
    """The probe target: the phase loss's neighborhood_target feature,
    falling back to the phase input (phase_probe.main's contract)."""
    ph = (bindings.losses or {}).get("phase_neighborhood") or {}
    nt = ph.get("neighborhood_target")
    if isinstance(nt, str):
        name = nt.split(".", 1)[1] if nt.startswith("features.") else nt
        if name in bindings.features:
            return name
    return phase_feature


def main(argv=None):
    """CLI: the reference's three phase-diagnostics report families from
    a trained checkpoint -- per-EVT gamma/temporal-fraction CSVs +
    heatmaps + ranking (+ probe R^2 with --probe), recovery box-plot
    grids, and ysfc KDE histogram sheets -- plus the compact combined
    figures.

    python -m forest_tpu_torch.eval.phase_diagnostics --checkpoint CKPT
        --bindings B.yaml --out DIR [--split train] [--n-patches 8]
        [--probe] [--top-k 20] [--device cuda]
    """
    import argparse

    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.eval import phase_probe as pp

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--split-block-size", type=int, nargs=2,
                    default=(4, 4))
    ap.add_argument("--n-patches", type=int, default=8)
    ap.add_argument("--evt-source", default="static_categorical.evt")
    ap.add_argument("--ysfc-source", default="annual.ysfc")
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--probe", action="store_true",
                    help="fit a phase probe and add the probe-dependent "
                         "families (recovery curves vs PREDICTED NBR, "
                         "per-EVT probe R^2)")
    ap.add_argument("--probe-max-batches", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the probe run "
                         "(default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split=a.split, patch_size=a.patch_size,
                         split_block_size=tuple(a.split_block_size))
    frozen.require_patches(ds, a.split, a.patch_size, a.split_block_size)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, enc_p, _ = frozen.make_encode_fns(model, fb)
    enc_pf = frozen.make_encode_phase_film(model, fb)

    phase_feature = getattr(model, "phase_feature", "phase_ccdc")
    target_feature = _resolve_phase_target(bindings, phase_feature) \
        if a.probe else None
    s = collect_phase_samples_full(
        enc_t, enc_pf, fb, ds, a.evt_source, a.ysfc_source,
        target_feature, a.n_patches, device=device)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)

    pred_nbr = obs_nbr = probe_pred = probe_target = probe_evt = None
    target_names = None
    if a.probe:
        targets_fn = make_phase_target_fn(fb, target_feature)

        def enc_phase_fn(batch, coords):
            zp = enc_p(batch, coords)
            ta, tm = targets_fn(batch, coords)
            return zp, ta, tm

        w, pre = pp.fit_phase_probe(
            enc_t, enc_phase_fn, ds, max_batches=a.probe_max_batches,
            device=device)
        n, t, dp = s["z_phase"].shape
        zt_rep = np.broadcast_to(s["z_type"][:, None, :],
                                 (n, t, s["z_type"].shape[-1]))
        pred = pp.predict_phase_probe(
            w, pre, torch.from_numpy(zt_rep.reshape(n * t, -1)).to(device),
            torch.from_numpy(s["z_phase"].reshape(n * t, dp)).to(device)
        ).cpu().numpy()                                # [N*T, C]
        target_names = list(
            fb.bindings.get_feature(target_feature).channels.keys())
        nbr_idx = next((i for i, nm in enumerate(target_names)
                        if "nbr" in nm.lower()), 0)
        probe_pred, probe_evt = pred, np.repeat(s["evt"], t)
        probe_target = s["target"].reshape(n * t, -1)
        pred_nbr = pred[:, nbr_idx]
        obs_nbr = probe_target[:, nbr_idx]

    summary = evt_phase_report(
        s["z_phase"], s["gamma"], s["evt"], out, top_k=a.top_k,
        probe_pred=probe_pred, probe_target=probe_target,
        probe_evt=probe_evt, target_names=target_names)
    ysfc_report(np.repeat(s["evt"], s["ysfc"].shape[-1]),
                s["ysfc"].ravel(), out, top_k=a.top_k)
    if pred_nbr is not None:
        recovery_report(probe_evt, s["ysfc"].ravel(), pred_nbr, obs_nbr,
                        out, top_k=a.top_k)
    # compact combined figures (kept for quick inspection)
    phase_evt_diagnostics(s["z_phase"], s["gamma"], s["evt"],
                          out / "phase_evt.png")
    phase_recovery_curves(s["z_phase"], s["ysfc"], s["evt"],
                          out / "recovery_compact.png")
    ysfc_evt_histograms(s["ysfc"], s["evt"], out / "ysfc_compact.png")
    n_files = len(list(out.iterdir()))
    print(f"wrote {n_files} diagnostic artifacts to {out} "
          f"({summary['n_evt_classes']} EVT classes, "
          f"{summary['n_pixels_total']} pixels)")


if __name__ == "__main__":
    main()


__all__ = ["collect_phase_samples", "collect_phase_samples_full",
           "phase_evt_diagnostics", "phase_recovery_curves",
           "ysfc_evt_histograms", "evt_phase_report", "recovery_report",
           "ysfc_report", "combine_evt_contingency_tables",
           "YSFC_BINS", "YSFC_BIN_LABELS", "main"]
