"""Hierarchical post-hoc landscape categorization: forest type x phase.

Port of ``forest_tpu/eval/landscape_categories.py`` (behavioural contract
from original: frl/training/fit_landscape_categories.py:1-1039):

1. Stream TRAIN patches through the frozen encoder and collect, per valid
   forest pixel, ``z_type`` plus a 3*zp phase summary (disturbed centroid,
   recovered centroid, overall mean of z_phase over T, with ysfc <= 1
   selecting disturbed and ysfc >= 5 recovered timesteps; slots without
   observations fall back to the overall mean) and the per-pixel temporal
   variance of z_phase (reference ``_compute_phase_summary``, :96-123).
2. Silhouette sweep on z_type selects K_type*; the winner is refit with
   more inits (reference ``_silhouette_sweep``, :250-330).
3. Per type cluster: dynamic iff q{Q}(temporal_var) > threshold; dynamic
   clusters get a phase silhouette sweep over K in {2,3,4} with a
   temporal-var-weighted bootstrap (:693-786); stable / tiny clusters get
   K_phase = 1.
4. Artifacts (reference :27-38 + main): type_gmm.pkl, phase_gmm_{k}.pkl,
   silhouette_curve_*.png, taxonomy.json, variability_summary.csv,
   type_variability.png, and the second-pass ysfc_by_phase.png grid.

On the device: the per-pixel work of a batch (the dense type forward with
the smoothing kernel, ``forward_phase`` over [B, T, H, W, C], the masked
T-reductions and the float16 casts) and the selection of the valid pixels,
whose compact float16 rows come to the host in one copy; the GMM fits and
silhouettes of :mod:`forest_tpu_torch.eval.cluster` (float64), and the
second pass's predictions. On the host: the reservoir, the variability
statistics and every file.

Figures: the pickles hold the port's ``GaussianMixture`` under the JAX
pickles' keys (neither package's pickle loads in the other without
scikit-learn). The figures need matplotlib, which the card's machine does
not have: where it does not import, each plotting function draws nothing
and logs one line naming the figure it skipped; every CSV, JSON and pickle
is written all the same.

Run: python -m forest_tpu_torch.eval.landscape_categories \
         --checkpoint CKPT --bindings B.yaml --output-dir OUT \
         [--k-type-min 2 ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import json
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from forest_tpu_torch.eval.cluster import GaussianMixture, silhouette_score
from forest_tpu_torch.utils.log import pyplot

# ysfc thresholds matching the recovery-discrimination loss defaults
# (reference fit_landscape_categories.py:88-90).
LOW_YSFC_MAX = 1.0
HIGH_YSFC_MIN = 5.0


# ---------------------------------------------------------------------------
# Phase summary (any leading batch dims)
# ---------------------------------------------------------------------------

def phase_summary(z_phase: torch.Tensor, ysfc: torch.Tensor):
    """(z_phase [..., T, D], ysfc [..., T] with NaN = unobserved) ->
    (summary [..., 3D], temporal_var [...]).

    summary = concat(disturbed centroid, recovered centroid, overall mean);
    centroids without any selected timestep fall back to the overall mean
    (reference _compute_phase_summary, fit_landscape_categories.py:96-123).
    The temporal variance is the population variance (ddof 0).
    """
    overall = z_phase.mean(-2)
    tvar = z_phase.var(-2, correction=0).mean(-1)

    def masked_mean(mask):
        w = mask.to(z_phase.dtype)[..., None]
        cen = (z_phase * w).sum(-2) / w.sum(-2).clamp(min=1.0)
        return torch.where(mask.any(-1)[..., None], cen, overall)

    valid = torch.isfinite(ysfc)
    dist = masked_mean(valid & (ysfc <= LOW_YSFC_MAX))
    rec = masked_mean(valid & (ysfc >= HIGH_YSFC_MIN))
    return torch.cat([dist, rec, overall], -1), tvar


# ---------------------------------------------------------------------------
# Streaming extraction (device side)
# ---------------------------------------------------------------------------

def make_extract_fn(model, fb, type_feature: str = "type_encoder_input",
                    phase_feature: str = "phase_ccdc",
                    ysfc_feature: str = "ysfc",
                    aoi_channel: str = "static_mask.aoi",
                    forest_channel: str = "static_mask.forest"):
    """``extract(batch) -> dict`` of dense per-pixel tensors on the model's
    device, for a batch of group tensors there:

    z_type [B,H,W,zt] f16, summary [B,H,W,3*zp] f16, tvar [B,H,W] f16,
    ysfc [B,H,W,T] f16, valid [B,H,W] bool.

    Validity mirrors the reference extract_batch mask
    (fit_landscape_categories.py:167-173): type-feature mask (all
    channels) & phase-feature mask (all channels AND all timesteps) &
    aoi & forest. The float16 casts quarter the bytes copied to the host.
    """

    def grid(batch, ref):
        g, c = ref.split(".")
        gc = fb.bindings.dataset[g]
        return batch[g][..., gc.channel_index(c)].float()

    @torch.inference_mode()
    def extract(batch):
        x, m_t = fb.build_feature(type_feature, batch)   # [B,H,W,C]
        z_type = model(x)                                # [B,H,W,zt]
        px, m_p = fb.build_feature(phase_feature, batch)  # [B,T,H,W,C]
        z_phase = model.forward_phase(px, z_type)        # [B,T,H,W,zp]
        y, y_m = fb.build_feature(ysfc_feature, batch)   # [B,T,H,W,1]
        ysfc = torch.where(y_m[..., 0], y[..., 0],
                           torch.full_like(y[..., 0], float("nan")))
        ysfc = torch.movedim(ysfc, 1, -1)                # [B,H,W,T]

        zp = torch.movedim(z_phase, 1, 3)                # [B,H,W,T,zp]
        summary, tvar = phase_summary(zp.float(), ysfc.float())

        valid = (m_t.all(-1) & m_p.all(-1).all(1)
                 & (grid(batch, aoi_channel) > 0)
                 & (grid(batch, forest_channel) > 0))
        return {"z_type": z_type.half(), "summary": summary.half(),
                "tvar": tvar.half(), "ysfc": ysfc.half(), "valid": valid}

    return extract


def stream_pixels(extract, dataset, batch_size: int = 4,
                  max_batches: Optional[int] = None,
                  keep_groups: Optional[set] = None, device="cuda"
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield per-batch dicts of VALID-pixel rows: z_type [N,zt],
    summary [N,3zp], tvar [N], ysfc [N,T]. Decode on the host -> extract
    and select on ``device`` -> one copy of the compact float16 rows."""
    from forest_tpu_torch.eval.frozen import batch_to_device

    keys = ("z_type", "summary", "tvar", "ysfc")
    n = len(dataset)
    for s in range(0, n, batch_size):
        if max_batches is not None and s // batch_size >= max_batches:
            break
        idx = list(range(s, min(s + batch_size, n)))
        out = extract(batch_to_device(dataset.load_batch(idx), device,
                                      keep_groups))
        m = out["valid"].reshape(-1)
        cols = [out[k].reshape(m.shape[0], -1) for k in keys]
        rows = torch.cat(cols, 1)[m].cpu().numpy()      # the one copy
        if not len(rows):
            continue
        edges = np.cumsum([0] + [c.shape[1] for c in cols])
        b = {k: rows[:, edges[i]:edges[i + 1]].astype(np.float32)
             for i, k in enumerate(keys)}
        b["tvar"] = b["tvar"][:, 0]
        yield b


# ---------------------------------------------------------------------------
# GMM sweeps (reference _bic_sweep / _silhouette_sweep)
# ---------------------------------------------------------------------------

def bic_sweep(x: np.ndarray, k_values: Sequence[int],
              covariance_type: str = "diag", n_init_sweep: int = 1,
              n_init_final: int = 3, max_iter: int = 200, seed: int = 42,
              device="cuda"):
    """-> (best_k, refit gmm, {k: bic}); sweep at n_init=1, winner refit."""
    bics: Dict[int, float] = {}
    for k in k_values:
        gm = GaussianMixture(n_components=k,
                             covariance_type=covariance_type,
                             n_init=n_init_sweep, max_iter=max_iter,
                             random_state=seed, device=device)
        gm.fit(x)
        bics[k] = float(gm.bic(x))
    best_k = min(bics, key=bics.__getitem__)
    best = GaussianMixture(n_components=best_k,
                           covariance_type=covariance_type,
                           n_init=n_init_final, max_iter=max_iter,
                           random_state=seed, device=device).fit(x)
    return best_k, best, bics


def silhouette_sweep(x: np.ndarray, k_values: Sequence[int],
                     covariance_type: str = "diag", n_init_sweep: int = 1,
                     n_init_final: int = 3, max_iter: int = 200,
                     seed: int = 42, n_silhouette_samples: int = 20_000,
                     sample_weight: Optional[np.ndarray] = None,
                     device="cuda"):
    """-> (best_k, refit gmm, {k: silhouette}).

    Silhouette (cluster separation) scores each K on an unweighted
    subsample; when ``sample_weight`` is given, fitting uses a weighted
    bootstrap resample so high-weight rows anchor the components (the
    reference's workaround, fit_landscape_categories.py:281-295). The
    subsample is drawn first and the bootstrap second, from one generator
    seeded with ``seed``; each fit starts from ``seed`` afresh.
    """
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(x), size=min(n_silhouette_samples, len(x)),
                     replace=False)
    x_sil = x[idx]

    x_fit = x
    if sample_weight is not None:
        w = np.clip(sample_weight.astype(np.float64), 0, None)
        if w.sum() > 0:
            w /= w.sum()
            x_fit = x[rng.choice(len(x), size=len(x), replace=True, p=w)]

    scores: Dict[int, float] = {}
    for k in k_values:
        gm = GaussianMixture(n_components=k,
                             covariance_type=covariance_type,
                             n_init=n_init_sweep, max_iter=max_iter,
                             random_state=seed, device=device)
        gm.fit(x_fit)
        lab = gm.predict(x_sil)
        scores[k] = (silhouette_score(x_sil, lab, device=device)
                     if len(np.unique(lab)) >= 2 else -1.0)
    best_k = max(scores, key=scores.__getitem__)
    best = GaussianMixture(n_components=best_k,
                           covariance_type=covariance_type,
                           n_init=n_init_final, max_iter=max_iter,
                           random_state=seed, device=device).fit(x_fit)
    return best_k, best, scores


def _save_score_plot(scores: Dict[int, float], best_k: int, ylabel: str,
                     title: str, out_path: Path) -> None:
    plt = pyplot(out_path.name)
    if plt is None:
        return

    ks = sorted(scores)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(ks, [scores[k] for k in ks], "o-", ms=4, lw=1.5)
    ax.axvline(best_k, color="red", ls="--", lw=1, label=f"K*={best_k}")
    ax.set_xlabel("K (number of components)")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Variability diagnostics (reference _compute_variability_stats)
# ---------------------------------------------------------------------------

def variability_stats(summary: np.ndarray, tvar: np.ndarray,
                      labels: np.ndarray, n_type: int, zp_dim: int
                      ) -> Dict[int, dict]:
    """Per-cluster temporal vs spatial variability; temporal_fraction
    -> 1 means within-pixel temporal change dominates, -> 0 means stable
    pixels with spatial heterogeneity (reference :393-427)."""
    overall = summary[:, 2 * zp_dim:3 * zp_dim]
    out: Dict[int, dict] = {}
    for k in range(n_type):
        sel = labels == k
        tv = tvar[sel]
        om = overall[sel]
        var_t = float(tv.mean()) if tv.size else 0.0
        var_s = float(om.var(axis=0).mean()) if len(om) > 1 else 0.0
        den = var_t + var_s
        out[k] = {
            "n_pixels": int(sel.sum()),
            "mean_temporal_var": var_t,
            "median_temporal_var": float(np.median(tv)) if tv.size else 0.0,
            "q25_temporal_var":
                float(np.percentile(tv, 25)) if tv.size else 0.0,
            "q75_temporal_var":
                float(np.percentile(tv, 75)) if tv.size else 0.0,
            "q90_temporal_var":
                float(np.percentile(tv, 90)) if tv.size else 0.0,
            "spatial_spread": var_s,
            "temporal_fraction": float(var_t / den) if den > 0 else 0.0,
        }
    return out


def write_variability_csv(var_stats: Dict[int, dict], taxonomy: Dict[int, dict],
                          out_path: Path) -> None:
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["cluster", "n_pixels", "k_phase", "is_dynamic",
                    "mean_temporal_var", "median_temporal_var",
                    "q25_temporal_var", "q75_temporal_var",
                    "q90_temporal_var", "spatial_spread",
                    "temporal_fraction"])
        for k, s in var_stats.items():
            t = taxonomy.get(k, {})
            w.writerow([k, s["n_pixels"], t.get("k_phase", 1),
                        t.get("is_dynamic", False),
                        f"{s['mean_temporal_var']:.6f}",
                        f"{s['median_temporal_var']:.6f}",
                        f"{s['q25_temporal_var']:.6f}",
                        f"{s['q75_temporal_var']:.6f}",
                        f"{s['q90_temporal_var']:.6f}",
                        f"{s['spatial_spread']:.6f}",
                        f"{s['temporal_fraction']:.4f}"])


def plot_type_variability(tvar: np.ndarray, labels: np.ndarray,
                          phase_labels: Dict[int, np.ndarray],
                          var_stats: Dict[int, dict],
                          taxonomy: Dict[int, dict], out_path: Path) -> None:
    """Violin of per-pixel temporal_var per type cluster, sorted by
    temporal_fraction, with phase sub-cluster overlays (reference
    _generate_variability_diagnostic figure)."""
    plt = pyplot(out_path.name)
    if plt is None:
        return
    from matplotlib.patches import Patch

    order = sorted(var_stats, key=lambda k: var_stats[k]["temporal_fraction"])
    colors = ["#4e9af1", "#f4a261", "#2a9d8f", "#e76f51", "#8ecae6"]
    fig, ax = plt.subplots(figsize=(9, max(4.0, len(order) * 0.35 + 1)))
    yticks, ylabels = [], []
    for row, k in enumerate(order):
        tv_k = tvar[labels == k]
        if tv_k.size == 0:
            continue
        k_phase = taxonomy.get(k, {}).get("k_phase", 1)
        vp = ax.violinplot([tv_k], positions=[row], vert=False,
                           showmedians=True, showextrema=False, widths=0.7)
        for pc in vp["bodies"]:
            pc.set_facecolor("#cccccc")
            pc.set_alpha(0.5)
        vp["cmedians"].set_color("#888888")
        pl = phase_labels.get(k)
        if pl is not None and k_phase > 1:
            for j in range(k_phase):
                tv_kj = tv_k[pl == j]
                if tv_kj.size < 5:
                    continue
                vp2 = ax.violinplot([tv_kj], positions=[row], vert=False,
                                    showmedians=True, showextrema=False,
                                    widths=0.5)
                col = colors[j % len(colors)]
                for pc in vp2["bodies"]:
                    pc.set_facecolor(col)
                    pc.set_alpha(0.6)
                vp2["cmedians"].set_color(col)
        yticks.append(row)
        ylabels.append(f"C{k}  tf={var_stats[k]['temporal_fraction']:.2f}"
                       f"  K_ph={k_phase}")
    ax.set_yticks(yticks)
    ax.set_yticklabels(ylabels, fontsize=7)
    ax.set_xlabel("per-pixel temporal variance of z_phase (mean over dims)")
    ax.set_title("Interannual variability by type cluster\n"
                 "grey = full cluster; colored = phase sub-clusters")
    handles = [Patch(facecolor="#cccccc", alpha=0.6,
                     label="full type cluster")]
    handles += [Patch(facecolor=colors[j], alpha=0.7,
                      label=f"phase sub-cluster {j}") for j in range(3)]
    ax.legend(handles=handles, loc="lower right", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_ysfc_by_phase(ysfc_store: Dict[Tuple[int, int], List[float]],
                       n_pixels: Dict[Tuple[int, int], int],
                       taxonomy: Dict[int, dict], out_path: Path) -> None:
    """Grid of ysfc violins per (dynamic type cluster, phase sub-cluster)
    (reference _run_ysfc_diagnostic figure)."""
    dyn = {k: t for k, t in taxonomy.items() if t.get("is_dynamic")}
    if not dyn:
        return
    plt = pyplot(out_path.name)
    if plt is None:
        return
    kp_max = max(t["k_phase"] for t in dyn.values())
    colors = ["#4e9af1", "#f4a261", "#2a9d8f", "#e76f51"]
    fig, axes = plt.subplots(len(dyn), kp_max,
                             figsize=(3 * kp_max, 2.5 * len(dyn)),
                             squeeze=False, sharey=True)
    for row, (k, t) in enumerate(sorted(dyn.items())):
        for j in range(kp_max):
            ax = axes[row, j]
            if j >= t["k_phase"]:
                ax.set_visible(False)
                continue
            vals = np.asarray(ysfc_store.get((k, j), ()), np.float32)
            vals = vals[np.isfinite(vals)]
            if vals.size >= 5:
                vp = ax.violinplot(vals, showmedians=True,
                                   showextrema=False)
                for pc in vp["bodies"]:
                    pc.set_facecolor(colors[j % len(colors)])
                    pc.set_alpha(0.7)
                vp["cmedians"].set_color("black")
            else:
                ax.text(0.5, 0.5, "no data", ha="center", va="center",
                        transform=ax.transAxes, fontsize=8)
            ax.set_title(f"C{k} / phase {j}\n"
                         f"n={n_pixels.get((k, j), 0):,}", fontsize=8)
            ax.set_xticks([])
    fig.suptitle("ysfc distribution by type cluster and phase sub-cluster")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Taxonomy fit (testable without a model)
# ---------------------------------------------------------------------------

def fit_taxonomy(z_type: np.ndarray, summary: np.ndarray, tvar: np.ndarray,
                 zp_dim: int, k_type_values: Sequence[int],
                 covariance_type: str = "diag",
                 min_cluster_pixels: int = 1000,
                 dynamic_var_quantile: int = 90,
                 dynamic_var_threshold: float = 0.25,
                 n_init: int = 3, n_init_sweep: int = 1,
                 max_iter: int = 200, seed: int = 42,
                 out_dir: Optional[Path] = None, device="cuda") -> Dict:
    """Type silhouette sweep -> per-cluster dynamic test -> phase sweeps,
    the fits on ``device``.

    Returns {gmm_type, k_type, type_labels, type_scores, taxonomy,
    phase_gmms, phase_labels, var_stats}; writes pkl/png/json/csv
    artifacts when ``out_dir`` is given (reference main(), :590-830).
    """
    k_type, gmm_type, type_scores = silhouette_sweep(
        z_type, k_type_values, covariance_type, n_init_sweep, n_init,
        max_iter, seed, device=device)
    type_labels = gmm_type.predict(z_type)
    var_stats = variability_stats(summary, tvar, type_labels, k_type, zp_dim)

    taxonomy: Dict[int, dict] = {}
    phase_gmms: Dict[int, object] = {}
    phase_labels: Dict[int, np.ndarray] = {}
    q_key = f"q{dynamic_var_quantile}_temporal_var"
    for k in range(k_type):
        sel = type_labels == k
        n_k = int(sel.sum())
        tv_k = tvar[sel]
        q_tail = (float(np.percentile(tv_k, dynamic_var_quantile))
                  if n_k else 0.0)
        is_dyn = q_tail > dynamic_var_threshold
        if n_k < min_cluster_pixels or not is_dyn:
            taxonomy[k] = {"n_type_pixels": n_k, "k_phase": 1,
                           "is_dynamic": False, q_key: q_tail,
                           "phase_gmm_skipped": True}
            continue
        ks = [kp for kp in (2, 3, 4) if kp <= n_k] or [2]
        kp, gm_p, p_scores = silhouette_sweep(
            summary[sel], ks, covariance_type, n_init_sweep, n_init,
            max_iter, seed, sample_weight=tv_k, device=device)
        phase_gmms[k] = gm_p
        phase_labels[k] = gm_p.predict(summary[sel])
        taxonomy[k] = {"n_type_pixels": n_k, "k_phase": kp,
                       "is_dynamic": True, q_key: q_tail,
                       "phase_silhouette": float(p_scores[kp]),
                       "phase_gmm_skipped": False}
        if out_dir is not None:
            _save_score_plot(p_scores, kp, "avg silhouette",
                             f"cluster {k} phase sweep (K*={kp})",
                             out_dir / f"silhouette_curve_phase_{k}.png")
            with open(out_dir / f"phase_gmm_{k}.pkl", "wb") as f:
                pickle.dump({"gmm": gm_p, "type_cluster": k, "k_phase": kp,
                             "is_dynamic": True,
                             "covariance_type": covariance_type,
                             "phase_summary_dim": summary.shape[1],
                             "n_pixels_fit": n_k,
                             "silhouette": float(p_scores[kp]),
                             "silhouette_curve": p_scores, q_key: q_tail},
                            f, protocol=5)

    if out_dir is not None:
        _save_score_plot(type_scores, k_type, "avg silhouette",
                         f"type sweep (K*={k_type})",
                         out_dir / "silhouette_curve_type.png")
        with open(out_dir / "type_gmm.pkl", "wb") as f:
            pickle.dump({"gmm": gmm_type, "n_components": k_type,
                         "covariance_type": covariance_type,
                         "z_type_dim": z_type.shape[1],
                         "n_pixels_fit": len(z_type),
                         "silhouette": float(type_scores[k_type]),
                         "silhouette_curve": type_scores, "seed": seed},
                        f, protocol=5)
        write_variability_csv(var_stats, taxonomy,
                              out_dir / "variability_summary.csv")
        plot_type_variability(tvar, type_labels, phase_labels, var_stats,
                              taxonomy, out_dir / "type_variability.png")

    return {"gmm_type": gmm_type, "k_type": k_type,
            "type_labels": type_labels, "type_scores": type_scores,
            "taxonomy": taxonomy, "phase_gmms": phase_gmms,
            "phase_labels": phase_labels, "var_stats": var_stats}


def taxonomy_json(fit: Dict, seed: int, dynamic_var_quantile: int,
                  dynamic_var_threshold: float, covariance_type: str,
                  checkpoint: str, n_pixels_fit: int) -> Dict:
    tax = fit["taxonomy"]
    n_dyn = sum(1 for v in tax.values() if v["is_dynamic"])
    return {"k_type": fit["k_type"],
            "n_dynamic_clusters": n_dyn,
            "n_nondynamic_clusters": fit["k_type"] - n_dyn,
            "dynamic_var_quantile": dynamic_var_quantile,
            "dynamic_var_threshold": dynamic_var_threshold,
            "low_ysfc_max": LOW_YSFC_MAX, "high_ysfc_min": HIGH_YSFC_MIN,
            "encoder_checkpoint": str(checkpoint),
            "covariance_type": covariance_type,
            "n_pixels_fit": int(n_pixels_fit),
            "clusters": {str(k): v for k, v in tax.items()}}


def collect_ysfc_by_phase(batches: Iterator[Dict[str, np.ndarray]],
                          gmm_type, phase_gmms: Dict[int, object],
                          taxonomy: Dict[int, dict],
                          max_per_group: int = 20_000
                          ) -> Tuple[Dict, Dict]:
    """Second streaming pass: valid ysfc timestep values per
    (type cluster, phase sub-cluster) for dynamic clusters
    (reference _run_ysfc_diagnostic, :849-1010)."""
    dyn = {k for k, t in taxonomy.items() if t.get("is_dynamic")}
    store: Dict[Tuple[int, int], List[float]] = {
        (k, j): [] for k in dyn for j in range(taxonomy[k]["k_phase"])}
    n_pix: Dict[Tuple[int, int], int] = {key: 0 for key in store}
    for b in batches:
        labels = gmm_type.predict(b["z_type"])
        for k in dyn:
            sel = labels == k
            if not sel.any():
                continue
            pl = phase_gmms[k].predict(b["summary"][sel])
            yf = b["ysfc"][sel]
            for j in range(taxonomy[k]["k_phase"]):
                key = (k, j)
                rows = yf[pl == j]
                n_pix[key] += int((pl == j).sum())
                s = store[key]
                if len(s) >= max_per_group:
                    continue
                vals = rows[np.isfinite(rows)]
                take = max_per_group - len(s)
                s.extend(vals[:take].tolist())
    return store, n_pix


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.data.samplers import ReservoirSampler
    from forest_tpu_torch.eval import frozen
    from forest_tpu_torch.utils.log import log

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--split", default="train")
    ap.add_argument("--split-block-size", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--k-type-min", type=int, default=5)
    ap.add_argument("--k-type-max", type=int, default=50)
    ap.add_argument("--k-type-step", type=int, default=5)
    ap.add_argument("--covariance-type", default="diag",
                    choices=["diag", "full", "tied", "spherical"])
    ap.add_argument("--max-pixels", type=int, default=500_000)
    ap.add_argument("--min-cluster-pixels", type=int, default=1000)
    ap.add_argument("--dynamic-var-quantile", type=int, default=90)
    ap.add_argument("--dynamic-var-threshold", type=float, default=0.25)
    ap.add_argument("--n-init", type=int, default=3)
    ap.add_argument("--n-init-sweep", type=int, default=1)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--type-feature", default="type_encoder_input")
    ap.add_argument("--ysfc-feature", default="ysfc")
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the fits run (default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    out_dir = Path(a.output_dir) if a.output_dir else \
        Path(a.checkpoint).parent / "taxonomy"
    out_dir.mkdir(parents=True, exist_ok=True)

    bindings = parse_bindings(a.bindings)
    ds = ForestDatasetV2(bindings, split=a.split, patch_size=a.patch_size,
                         split_block_size=tuple(a.split_block_size),
                         min_aoi=0.3)
    fb = FeatureBuilder(bindings)
    model = frozen.load_frozen_model(a.checkpoint, device)
    phase_feature = getattr(model, "phase_feature", "phase_ccdc")
    zp_dim = model.z_phase_dim
    extract = make_extract_fn(model, fb, a.type_feature, phase_feature,
                              a.ysfc_feature)
    keep = set(bindings.groups_for_features(
        [a.type_feature, phase_feature, a.ysfc_feature])) | {"static_mask"}

    frozen.require_patches(ds, a.split, a.patch_size, a.split_block_size)
    log(f"pass 1: collecting up to {a.max_pixels} pixels "
        f"from {len(ds)} patches")
    rs = ReservoirSampler(a.max_pixels, seed=a.seed)
    n_seen = 0
    for b in stream_pixels(extract, ds, a.batch_size, a.max_batches, keep,
                           device):
        rows = np.concatenate([b["z_type"], b["summary"],
                               b["tvar"][:, None]], axis=1)
        rs.add(rows)
        n_seen += len(rows)
    buf = rs.sample()
    if len(buf) == 0:
        raise SystemExit(
            "collected 0 valid forest pixels: every pixel in the streamed "
            "patches is masked out (aoi/forest/dem masks) or NaN — check the "
            "mask channels in the bindings, or raise --max-batches")
    zt_dim = model.z_type_dim
    z_type = buf[:, :zt_dim]
    summary = buf[:, zt_dim:zt_dim + 3 * zp_dim]
    tvar = buf[:, -1]
    log(f"reservoir: {len(buf)} pixels (seen {n_seen})")

    ks = list(range(a.k_type_min, a.k_type_max + 1, a.k_type_step))
    ks = [k for k in ks if k <= max(len(buf) - 1, 2)] or [2]
    fit = fit_taxonomy(z_type, summary, tvar, zp_dim, ks,
                       a.covariance_type, a.min_cluster_pixels,
                       a.dynamic_var_quantile, a.dynamic_var_threshold,
                       a.n_init, a.n_init_sweep, a.max_iter, a.seed,
                       out_dir=out_dir, device=device)
    tj = taxonomy_json(fit, a.seed, a.dynamic_var_quantile,
                       a.dynamic_var_threshold, a.covariance_type,
                       a.checkpoint, len(buf))
    (out_dir / "taxonomy.json").write_text(json.dumps(tj, indent=2))
    log(f"taxonomy: {fit['k_type']} type clusters "
        f"({tj['n_dynamic_clusters']} dynamic)")

    if fit["phase_gmms"]:
        log("pass 2: ysfc-by-phase diagnostic")
        store, n_pix = collect_ysfc_by_phase(
            stream_pixels(extract, ds, a.batch_size, a.max_batches, keep,
                          device),
            fit["gmm_type"], fit["phase_gmms"], fit["taxonomy"])
        plot_ysfc_by_phase(store, n_pix, fit["taxonomy"],
                           out_dir / "ysfc_by_phase.png")
        fit["ysfc_by_phase_pixels"] = n_pix
    log(f"artifacts written to {out_dir}")
    print(f"wrote {out_dir}")


if __name__ == "__main__":
    main()


__all__ = ["phase_summary", "make_extract_fn", "stream_pixels",
           "bic_sweep", "silhouette_sweep", "variability_stats",
           "write_variability_csv", "fit_taxonomy", "taxonomy_json",
           "collect_ysfc_by_phase", "plot_type_variability",
           "plot_ysfc_by_phase", "LOW_YSFC_MAX", "HIGH_YSFC_MIN", "main"]
