"""FIA small-area estimation utilities: post-stratification + kNN models.

Port of ``forest_tpu/eval/fia.py``. The numpy estimators are copied as
they are, Ward's linkage stays scipy's; the kNN models, HDBSCAN and
k-means run on ``device`` through the port's own estimators
(:mod:`forest_tpu_torch.eval.cluster`) where the JAX package calls
scikit-learn. The strata boxplot needs matplotlib: where it does not import,
it is skipped with one log line, and the tables are written all the same.

The reference's downstream science lives in R notebooks
(original: frl/analysis/*.Rmd -- FIA post-stratification variance,
kNN imputation models, embedding-derived strata; SURVEY.md §2.7 L7). This
module provides the same estimators in Python so the full workflow runs
inside forest-tpu:

- ``post_stratified_estimate``: the standard FIA post-stratified mean and
  variance estimator (Cochran 1977 / Bechtold & Patterson 2005):
      ybar_ps = sum_h W_h * ybar_h
      var     = (1/n) sum_h W_h s_h^2 + (1/n^2) sum_h (1 - W_h) s_h^2
  where W_h are population stratum weights (e.g. pixel-count shares of
  embedding-derived strata) and (ybar_h, s_h^2, n_h) come from plot data;
- ``embedding_strata``: derive strata labels for plots + population from a
  fitted cluster model (GMM over z_type, eval/gmm.py);
- ``knn_impute``: k-nearest-neighbor imputation of a plot attribute over
  embedding space (the kNN models notebook).

Round-2 additions port the remaining notebooks' estimators:

- ``hierarchical_type_phase_strata`` + ``aggregate_bins_by_target`` /
  ``apply_bin_map`` (fia_hierarchical_strata.Rmd): Ward type bins ->
  phase-variability-ranked subdivision -> target-aggregated strata, with
  the transfer (BALIVE-trained, removals-scored) path;
- ``hdbscan_strata`` / ``density_strata_report``
  (fia_hdbscan_strata.Rmd): density-based clusters tuned to a target k via
  a minPts grid, noise 1-NN-reassigned, target-aggregated;
- ``dh_strata`` (Dalenius-Hodges cumulative-sqrt(f) boundaries),
  ``pooled_within_variance``, ``oof_linear_scores``, and
  ``removals_stratification_report`` (fia_removals_stratification.Rmd):
  the zero-inflated removals efficiency table incl. the supervised and
  transfer stratifications;
- ``adjusted_r2`` / ``linear_probe_table`` / ``blockwise_l2_normalize`` /
  ``knn_eval`` / ``tune_phase_weight_and_k`` / ``error_by_strata`` /
  ``response_by_recovery_class`` (fia_embedding_evaluation.Rmd): probe
  and kNN evaluation metrics with block scaling and per-stratum error;
- ``evt_centroid_segments`` / ``evt_cohesion``
  (fia_evt_type_clustering.Rmd): EVT-centroid Ward typology with
  rare-EVT nearest-centroid attachment, location-based plot assignment,
  cohesion metrics, and the cannot-link (macro-pure) constrained variant
  with embedding-only leakage.

With these, all 7 analysis notebooks' estimators have Python ports.

CLI: python -m forest_tpu_torch.eval.fia --csv emb.csv --target BALIVE
        --analysis {hierarchical,hdbscan,removals,probe_table}
        [--device cuda]
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from forest_tpu_torch.eval.cluster import (HDBSCAN, KMeans,
                                           KNeighborsRegressor, kneighbors)
from forest_tpu_torch.utils.log import pyplot


def post_stratified_estimate(y: np.ndarray, strata: np.ndarray,
                             stratum_weights: Dict[int, float]
                             ) -> Dict[str, float]:
    """Post-stratified mean/variance of plot attribute ``y``.

    y [n]: plot responses; strata [n]: stratum label per plot;
    stratum_weights: population share W_h per label (sums to ~1). Strata
    with < 2 plots contribute their mean but zero variance (flagged in the
    output); labels missing from the plot sample are dropped with their
    weight renormalized.
    """
    y = np.asarray(y, np.float64)
    strata = np.asarray(strata)
    n = len(y)
    labels = [h for h in stratum_weights if (strata == h).any()]
    w_total = sum(stratum_weights[h] for h in labels)
    if not labels or w_total <= 0:
        raise ValueError("no plot data in any weighted stratum")

    mean = 0.0
    v1 = 0.0
    v2 = 0.0
    small = []
    per_stratum = {}
    for h in labels:
        sel = strata == h
        n_h = int(sel.sum())
        w_h = stratum_weights[h] / w_total
        ybar_h = float(y[sel].mean())
        s2_h = float(y[sel].var(ddof=1)) if n_h > 1 else 0.0
        if n_h < 2:
            small.append(int(h))
        mean += w_h * ybar_h
        v1 += w_h * s2_h
        v2 += (1.0 - w_h) * s2_h
        per_stratum[int(h)] = {"n": n_h, "W": w_h, "mean": ybar_h,
                               "s2": s2_h}
    variance = v1 / n + v2 / (n * n)
    return {"mean": mean, "variance": variance,
            "se": float(np.sqrt(variance)), "n_plots": n,
            "n_strata": len(labels), "small_strata": small,
            "per_stratum": per_stratum}


def simple_random_estimate(y: np.ndarray) -> Dict[str, float]:
    """Unstratified baseline (for relative-efficiency comparisons)."""
    y = np.asarray(y, np.float64)
    n = len(y)
    var = float(y.var(ddof=1)) / n if n > 1 else 0.0
    return {"mean": float(y.mean()), "variance": var,
            "se": float(np.sqrt(var)), "n_plots": n}


def relative_efficiency(y: np.ndarray, strata: np.ndarray,
                        stratum_weights: Dict[int, float]) -> float:
    """Var(SRS) / Var(post-stratified): > 1 means the strata help."""
    ps = post_stratified_estimate(y, strata, stratum_weights)
    srs = simple_random_estimate(y)
    return srs["variance"] / max(ps["variance"], 1e-30)


def embedding_strata(cluster_model, z_plots: np.ndarray,
                     z_population: Optional[np.ndarray] = None,
                     population_counts: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Dict[int, float]]:
    """Strata labels for plots + population weights from a cluster model.

    cluster_model: fitted sklearn-style model with ``predict`` (e.g. the
    GMM from eval/gmm.fit_gmm_clusters). Population weights come from
    labeling ``z_population`` (a large pixel sample) or directly from
    ``population_counts`` per label.
    """
    plot_labels = np.asarray(cluster_model.predict(z_plots))
    if population_counts is not None:
        counts = np.asarray(population_counts, np.float64)
        weights = {int(i): float(c / counts.sum())
                   for i, c in enumerate(counts)}
    elif z_population is not None:
        pop = np.asarray(cluster_model.predict(z_population))
        labels, counts = np.unique(pop, return_counts=True)
        weights = {int(l): float(c / counts.sum())
                   for l, c in zip(labels, counts)}
    else:
        raise ValueError("need z_population or population_counts")
    return plot_labels, weights


def knn_impute(z_train: np.ndarray, y_train: np.ndarray,
               z_query: np.ndarray, k: int = 7,
               weighted: bool = True, device="cuda") -> np.ndarray:
    """kNN imputation of plot attributes over embedding space
    (the kNN-models notebook contract). Distance-weighted mean of the k
    nearest training plots per query point, on ``device``."""
    reg = KNeighborsRegressor(
        n_neighbors=min(k, len(z_train)),
        weights="distance" if weighted else "uniform", device=device)
    reg.fit(np.asarray(z_train), np.asarray(y_train))
    return reg.predict(np.asarray(z_query))


# ---------------------------------------------------------------------------
# Shared stratification helpers (fia_hierarchical_strata.Rmd,
# fia_hdbscan_strata.Rmd, fia_removals_stratification.Rmd)
# ---------------------------------------------------------------------------

def ward_cluster(x: np.ndarray, k: int) -> np.ndarray:
    """Ward agglomerative labels 0..k-1 (the notebooks' ward() helper:
    hclust(dist(X), "ward.D2") + cutree, fia_hierarchical_strata.Rmd
    Step 1). Ward minimizes within-cluster variance -- the stratification
    objective."""
    from scipy.cluster.hierarchy import fcluster, linkage

    x = np.atleast_2d(np.asarray(x, np.float64))
    if x.shape[0] <= 1 or k <= 1:
        return np.zeros(x.shape[0], np.int64)
    z = linkage(x, method="ward")
    return fcluster(z, t=min(k, x.shape[0]), criterion="maxclust") - 1


def _standardize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    mu = x.mean(0)
    sd = x.std(0, ddof=1)
    return (x - mu) / np.where(sd > 0, sd, 1.0)


def dh_strata(x: np.ndarray, k: int, nbins: int = 100) -> np.ndarray:
    """Dalenius-Hodges cumulative-sqrt(f) strata labels 0..<k.

    The optimal-boundary rule for a skewed stratification variable
    (fia_removals_stratification.Rmd `dh_strata`): histogram x, cumulate
    sqrt(counts), place boundaries at equal cum-sqrt-f targets.
    """
    x = np.asarray(x, np.float64)
    finite = x[np.isfinite(x)]
    if finite.size == 0 or finite.max() == finite.min():
        return np.zeros(len(x), np.int64)
    counts, edges = np.histogram(
        finite, bins=np.linspace(finite.min(), finite.max(), nbins + 1))
    csf = np.cumsum(np.sqrt(counts))
    tgt = np.linspace(0, csf[-1], k + 1)[1:-1]
    bnd = sorted({float(edges[int(np.searchsorted(csf, t)) + 1])
                  for t in tgt})
    return np.searchsorted(np.asarray(bnd), x, side="right")


def pooled_within_variance(y: np.ndarray, *group_labels: np.ndarray
                           ) -> float:
    """Pooled within-group variance sum_g SS_g / (n - G) over the cross of
    the given label arrays (the notebooks' pooled_within; the efficiency
    score every stratification is ranked by)."""
    y = np.asarray(y, np.float64)
    key = np.zeros(len(y), np.int64)
    for g in group_labels:
        _, codes = np.unique(np.asarray(g), return_inverse=True)
        key = key * (codes.max() + 1) + codes
    groups = np.unique(key)
    ss = 0.0
    for g in groups:
        v = y[key == g]
        ss += float(((v - v.mean()) ** 2).sum())
    dof = len(y) - len(groups)
    return ss / max(dof, 1)


def aggregate_bins_by_target(fine_bin: np.ndarray, y: np.ndarray,
                             k_strata: int) -> Dict[int, int]:
    """Fine bins -> strata mapping: Ward on the scaled bin-mean response
    (the supervised aggregation step, fia_hierarchical_strata.Rmd Step 4 /
    fia_hdbscan_strata.Rmd bin_map). Returns {bin_label: stratum}."""
    fine_bin = np.asarray(fine_bin)
    y = np.asarray(y, np.float64)
    bins = np.unique(fine_bin)
    means = np.array([y[fine_bin == b].mean() for b in bins])
    if len(bins) <= 1:
        return {int(b): 0 for b in bins}
    lab = ward_cluster(_standardize(means[:, None]),
                       min(k_strata, len(bins)))
    return {int(b): int(s) for b, s in zip(bins, lab)}


def apply_bin_map(fine_bin: np.ndarray, mapping: Dict[int, int]
                  ) -> np.ndarray:
    """Apply a fine-bin -> stratum map (transfer case: a map trained on one
    target scored on another, fia_hdbscan_strata.Rmd fit_agg/apply_agg)."""
    return np.asarray([mapping[int(b)] for b in np.asarray(fine_bin)],
                      np.int64)


def oof_linear_scores(x: np.ndarray, y: np.ndarray, n_folds: int = 5,
                      seed: int = 1) -> np.ndarray:
    """Out-of-fold linear-probe scores (the notebooks' flat supervised
    stratifier input: 5-fold OOF lm prediction of the target from the
    embedding, then DH-binned)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xb = np.concatenate([x, np.ones((len(x), 1))], 1)
    rng = np.random.default_rng(seed)
    folds = rng.permutation(np.arange(len(x)) % n_folds)
    out = np.zeros(len(x))
    for f in range(n_folds):
        tr = folds != f
        w, *_ = np.linalg.lstsq(xb[tr], y[tr], rcond=None)
        out[~tr] = xb[~tr] @ w
    return out


# ---------------------------------------------------------------------------
# Hierarchical type/phase strata (fia_hierarchical_strata.Rmd)
# ---------------------------------------------------------------------------

def hierarchical_type_phase_strata(z_type: np.ndarray, z_phase: np.ndarray,
                                   y: np.ndarray, k_type: int = 20,
                                   phase_subdivide_frac: float = 0.25,
                                   k_phase: int = 3, k_strata: int = 5,
                                   min_split_factor: int = 10) -> Dict:
    """Structure-aware stratification (fia_hierarchical_strata.Rmd):

    1. Ward type bins on standardized z_type;
    2. rank bins by within-bin z_phase spread (sum of per-dim variances of
       the standardized z_phase);
    3. subdivide the top ``phase_subdivide_frac`` bins into ``k_phase``
       Ward phase sub-groups (only bins with >= min_split_factor*k_phase
       plots) -> fine bins;
    4. aggregate fine bins to ``k_strata`` by Ward on mean ``y``.

    Returns {type_bin, fine_bin, stratum, phase_var (per bin),
    subdivided (bin ids), bin_map} -- bin_map supports transfer scoring.
    """
    zt = _standardize(z_type)
    zp = _standardize(z_phase)
    y = np.asarray(y, np.float64)
    type_bin = ward_cluster(zt, k_type)
    n_bins = type_bin.max() + 1

    phase_var = {}
    for b in range(n_bins):
        sel = type_bin == b
        phase_var[int(b)] = (float(zp[sel].var(0, ddof=1).sum())
                             if sel.sum() > 1 else 0.0)
    n_sub = int(round(phase_subdivide_frac * n_bins))
    sub_bins = sorted(phase_var, key=phase_var.__getitem__,
                      reverse=True)[:n_sub]

    phase_sub = np.zeros(len(y), np.int64)
    for b in sub_bins:
        idx = np.flatnonzero(type_bin == b)
        if len(idx) >= min_split_factor * k_phase:
            phase_sub[idx] = ward_cluster(zp[idx], k_phase)
    fine_bin = type_bin * (phase_sub.max() + 1) + phase_sub
    # densify fine-bin ids
    _, fine_bin = np.unique(fine_bin, return_inverse=True)

    bin_map = aggregate_bins_by_target(fine_bin, y, k_strata)
    stratum = apply_bin_map(fine_bin, bin_map)
    return {"type_bin": type_bin, "fine_bin": fine_bin,
            "stratum": stratum, "phase_var": phase_var,
            "subdivided": sub_bins, "bin_map": bin_map}


# ---------------------------------------------------------------------------
# Density-based (HDBSCAN) strata (fia_hdbscan_strata.Rmd)
# ---------------------------------------------------------------------------

def assign_noise_to_nearest(x: np.ndarray, labels: np.ndarray,
                            device="cuda") -> np.ndarray:
    """Assign noise points (label -1) to their nearest clustered neighbor
    (1-NN in the same space, on ``device``; fia_hdbscan_strata.Rmd
    assign_noise)."""
    labels = np.asarray(labels).copy()
    noise = labels < 0
    if not noise.any() or noise.all():
        return labels
    keep = np.flatnonzero(~noise)
    _, j = kneighbors(x[keep], x[noise], 1, device=device)
    labels[noise] = labels[keep][j[:, 0]]
    return labels


def hdbscan_strata(x: np.ndarray, k_target: int,
                   minpts_grid: Sequence[int] = (10, 20, 40, 70, 120, 200,
                                                 320, 500),
                   device="cuda") -> Dict:
    """HDBSCAN clustering tuned to ~k_target clusters.

    HDBSCAN has no k; cluster count is governed by minPts. Search the grid
    and keep the run whose cluster count is closest to the target, then
    reassign noise via 1-NN so every plot lands in a bin
    (fia_hdbscan_strata.Rmd hdbscan_k). Returns {labels, min_pts, k,
    noise_frac, grid: [(minpts, k, noise_frac)]}.
    """
    x = _standardize(x)
    runs = []
    for mp in minpts_grid:
        mp = int(min(mp, max(len(x) - 1, 2)))
        h = HDBSCAN(min_cluster_size=mp, min_samples=mp,
                    device=device).fit(x)
        lab = h.labels_
        runs.append({"min_pts": mp, "labels": lab,
                     "k": int(len(set(lab[lab >= 0]))),
                     "noise_frac": float((lab < 0).mean())})
    valid = [r for r in runs if r["k"] >= 1] or runs
    best = min(valid, key=lambda r: abs(r["k"] - k_target))
    labels = assign_noise_to_nearest(x, best["labels"], device)
    return {"labels": labels, "min_pts": best["min_pts"], "k": best["k"],
            "noise_frac": best["noise_frac"],
            "grid": [(r["min_pts"], r["k"], r["noise_frac"])
                     for r in runs]}


def density_strata_report(z: np.ndarray, y: np.ndarray,
                          units: Optional[np.ndarray] = None,
                          k_cluster: int = 20, k_strata: int = 5,
                          minpts_grid: Sequence[int] = (10, 20, 40, 70,
                                                        120, 200),
                          device="cuda") -> Dict:
    """HDBSCAN clusters -> target-aggregated strata + efficiency row
    (fia_hdbscan_strata.Rmd resp_table for one scheme). ``units`` is the
    survey-unit cross (UNITCD); omitted = single unit."""
    units = np.zeros(len(y), np.int64) if units is None else units
    hdb = hdbscan_strata(z, k_cluster, minpts_grid, device)
    bin_map = aggregate_bins_by_target(hdb["labels"], y, k_strata)
    stratum = apply_bin_map(hdb["labels"], bin_map)
    v_base = pooled_within_variance(y, units)
    v = pooled_within_variance(y, units, stratum)
    return {"stratum": stratum, "hdbscan": hdb, "bin_map": bin_map,
            "within_var": v, "baseline_var": v_base,
            "pct_of_baseline": 100.0 * v / max(v_base, 1e-30),
            "ess": len(y) * v_base / max(v, 1e-30)}


# ---------------------------------------------------------------------------
# Removals stratification report (fia_removals_stratification.Rmd)
# ---------------------------------------------------------------------------

def removals_stratification_report(z_type: np.ndarray, z_all: np.ndarray,
                                   removals: np.ndarray,
                                   transfer_target: Optional[np.ndarray]
                                   = None,
                                   units: Optional[np.ndarray] = None,
                                   aux: Optional[np.ndarray] = None,
                                   k_strata: int = 4, seed: int = 1,
                                   return_labels: bool = False,
                                   device="cuda"):
    """Within-stratum variance comparison for a zero-inflated removals
    target (fia_removals_stratification.Rmd headline table):

    - ``baseline``: units only;
    - ``aux_dh``: DH bins of an auxiliary covariate (the TCC role) when
      given;
    - ``emb_unsup``: unsupervised k-means regions of z_type;
    - ``emb_sup_type`` / ``emb_sup``: OOF linear probe of removals from
      z_type / the full embedding, DH-binned;
    - ``emb_transfer``: probe trained on ``transfer_target`` (the BALIVE
      role), applied to removals -- the shared-stratification case.

    Each row: within_var, pct_of_baseline, ess (n * V_base / V). The
    k-means runs on ``device``.
    """
    y = np.asarray(removals, np.float64)
    units = np.zeros(len(y), np.int64) if units is None else units
    v_base = pooled_within_variance(y, units)
    rows: Dict[str, Dict[str, float]] = {}
    labels: Dict[str, np.ndarray] = {}

    def add(name, *strata):
        v = pooled_within_variance(y, units, *strata)
        rows[name] = {"within_var": v,
                      "pct_of_baseline": 100.0 * v / max(v_base, 1e-30),
                      "ess": len(y) * v_base / max(v, 1e-30)}
        labels[name] = strata[0] if strata else units

    rows["baseline"] = {"within_var": v_base, "pct_of_baseline": 100.0,
                        "ess": float(len(y))}
    if aux is not None:
        add("aux_dh", dh_strata(aux, k_strata))
    km = KMeans(n_clusters=min(k_strata, len(y)), n_init=10,
                random_state=seed, device=device).fit(_standardize(z_type))
    add("emb_unsup", km.labels_)
    add("emb_sup_type", dh_strata(oof_linear_scores(z_type, y, seed=seed),
                                  k_strata))
    add("emb_sup", dh_strata(oof_linear_scores(z_all, y, seed=seed),
                             k_strata))
    if transfer_target is not None:
        add("emb_transfer", dh_strata(
            oof_linear_scores(z_all, np.asarray(transfer_target,
                                                np.float64), seed=seed),
            k_strata))
    if return_labels:
        return rows, labels
    return rows


# ---------------------------------------------------------------------------
# Embedding evaluation (fia_embedding_evaluation.Rmd)
# ---------------------------------------------------------------------------

def adjusted_r2(pred: np.ndarray, y: np.ndarray, n_features: int) -> float:
    """Adjusted R^2 (the notebook's probe summary metric, section 1)."""
    y = np.asarray(y, np.float64)
    pred = np.asarray(pred, np.float64)
    n = len(y)
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    if ss_tot <= 0 or n - n_features - 1 <= 0:
        return 0.0
    r2 = 1.0 - ss_res / ss_tot
    return 1.0 - (1.0 - r2) * (n - 1) / (n - n_features - 1)


def linear_probe_table(blocks: Dict[str, np.ndarray], y: np.ndarray,
                       n_folds: int = 5, seed: int = 1
                       ) -> Dict[str, Dict[str, float]]:
    """Per-feature-block OOF linear probes with adjusted R^2
    (fia_embedding_evaluation.Rmd section 1): which block (z_type,
    z_phase, inputs, combinations) predicts the target best."""
    out = {}
    for name, x in blocks.items():
        x = np.atleast_2d(np.asarray(x, np.float64))
        pred = oof_linear_scores(x, y, n_folds, seed)
        out[name] = {"adj_r2": adjusted_r2(pred, y, x.shape[1]),
                     "rmse": float(np.sqrt(np.mean(
                         (pred - np.asarray(y)) ** 2))),
                     "n_features": int(x.shape[1])}
    return out


def blockwise_l2_normalize(blocks: Dict[str, np.ndarray],
                           weights: Optional[Dict[str, float]] = None
                           ) -> np.ndarray:
    """Concatenate feature blocks after the notebook's pop_l2_normalize
    (fia_embedding_evaluation.Rmd:292-301): divide by the mean train L2
    norm, then row-normalize -- which reduces to per-ROW unit-L2 per block
    (the scalar population factor cancels under row normalization), so the
    result is split-independent and train/val/test stay in one consistent
    scaling. Per-block ``weights`` apply AFTER normalization (the
    type-vs-phase scale knob, Rmd:433-434)."""
    cols = []
    for name, x in blocks.items():
        x = np.atleast_2d(np.asarray(x, np.float64))
        norm = np.sqrt((x ** 2).sum(1, keepdims=True))
        w = (weights or {}).get(name, 1.0)
        cols.append(x * (w / np.maximum(norm, 1e-12)))
    return np.concatenate(cols, axis=1)


def knn_eval(z_train: np.ndarray, y_train: np.ndarray, z_test: np.ndarray,
             y_test: np.ndarray, k: int = 10, device="cuda"
             ) -> Dict[str, float]:
    """kNN imputation error on a held-out split (section 2 baseline)."""
    pred = knn_impute(z_train, y_train, z_test, k=k, device=device)
    err = pred - np.asarray(y_test, np.float64)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))),
            "mae": float(np.mean(np.abs(err))), "k": int(k)}


def tune_phase_weight_and_k(z_type_tr, z_phase_tr, y_tr, z_type_va,
                            z_phase_va, y_va,
                            weight_grid: Sequence[float] = (0.0, 0.25, 0.5,
                                                            1.0, 2.0, 4.0),
                            k_grid: Sequence[int] = (3, 5, 10, 20),
                            device="cuda") -> Dict:
    """Type-vs-phase scale tuning + k sweep (sections 3/4): for each k,
    re-optimize the phase-block weight on validation RMSE; return the best
    (k, weight) and the full sweep."""
    sweep = []
    best = None
    for k in k_grid:
        for w in weight_grid:
            blocks_tr = blockwise_l2_normalize(
                {"type": z_type_tr, "phase": z_phase_tr},
                weights={"phase": w})
            blocks_va = blockwise_l2_normalize(
                {"type": z_type_va, "phase": z_phase_va},
                weights={"phase": w})
            res = knn_eval(blocks_tr, y_tr, blocks_va, y_va,
                           k=min(k, len(blocks_tr)), device=device)
            entry = {"k": int(k), "phase_weight": float(w),
                     "rmse": res["rmse"]}
            sweep.append(entry)
            if best is None or entry["rmse"] < best["rmse"]:
                best = entry
    return {"best": best, "sweep": sweep}


def error_by_strata(pred: np.ndarray, y: np.ndarray, n_deciles: int = 10
                    ) -> Dict[str, Dict[str, float]]:
    """Per-stratum RMSE: the zero class plus positive-value deciles
    (fia_embedding_evaluation.Rmd section 5 -- where in the response range
    the embedding wins)."""
    pred = np.asarray(pred, np.float64)
    y = np.asarray(y, np.float64)
    out = {}
    zero = y == 0
    if zero.any():
        out["zero"] = {"n": int(zero.sum()),
                       "rmse": float(np.sqrt(np.mean(
                           (pred[zero] - y[zero]) ** 2)))}
    pos = y > 0
    if pos.any():
        qs = np.quantile(y[pos], np.linspace(0, 1, n_deciles + 1))
        dec = np.clip(np.searchsorted(qs[1:-1], y, side="right"), 0,
                      n_deciles - 1)
        for d in range(n_deciles):
            sel = pos & (dec == d)
            if sel.any():
                out[f"decile_{d}"] = {
                    "n": int(sel.sum()),
                    "rmse": float(np.sqrt(np.mean(
                        (pred[sel] - y[sel]) ** 2)))}
    return out


def response_by_recovery_class(y: np.ndarray, ysfc: np.ndarray,
                               bins: Sequence[float] = (0, 2, 5, 10, 20)
                               ) -> Dict[str, Dict[str, float]]:
    """Target distribution by ysfc recovery class (section 6): never
    disturbed (NaN) + ysfc bins."""
    y = np.asarray(y, np.float64)
    ysfc = np.asarray(ysfc, np.float64)
    out = {}

    def stats(sel, name):
        if sel.any():
            v = y[sel]
            out[name] = {"n": int(sel.sum()), "mean": float(v.mean()),
                         "median": float(np.median(v)),
                         "sd": float(v.std(ddof=1)) if sel.sum() > 1
                         else 0.0}

    stats(~np.isfinite(ysfc), "never_disturbed")
    edges = list(bins) + [np.inf]
    for i in range(len(edges) - 1):
        sel = np.isfinite(ysfc) & (ysfc >= edges[i]) & (ysfc < edges[i + 1])
        stats(sel, f"ysfc_{edges[i]:g}_{edges[i + 1]:g}")
    return out


# ---------------------------------------------------------------------------
# EVT-centroid typology (fia_evt_type_clustering.Rmd)
# ---------------------------------------------------------------------------

def evt_centroid_segments(z: np.ndarray, evt: np.ndarray, k: int,
                          min_evt_n: int = 20,
                          macro: Optional[Dict] = None) -> Dict:
    """EVT-seeded z_type typology (fia_evt_type_clustering.Rmd):

    1. per-EVT centroids in standardized z; EVTs with >= ``min_evt_n``
       plots are the clustering atoms;
    2. Ward on the big-EVT centroids, cut at ``k``; rare EVTs attach to
       the nearest cluster centroid (same-macro nearest when ``macro``
       constrains);
    3. segment centroids recomputed from the plots seeded by the EVT
       grouping; EVERY plot then assigned to its nearest segment centroid
       by its own z location (an EVT may split across segments).

    ``macro``: optional {evt_code: bool} macro-class map (the notebook's
    Tree/non-Tree EVT_LF); when given, the Ward runs cannot-link (cross-
    macro centroid distances inflated so those merges are deferred) and
    rare EVTs attach within their macro only.

    Returns {segments [n], evt_group {code: seg}, seg_macro {seg: bool},
    cohesion, frac_single_segment, leakage}.
    """
    z = _standardize(z)
    evt = np.asarray(evt)
    codes, counts = np.unique(evt, return_counts=True)
    cent = np.stack([z[evt == c].mean(0) for c in codes])
    big = counts >= min_evt_n
    if not big.any():
        big = counts >= 1
    cent_big = cent[big]
    kk = min(k, len(cent_big))

    if macro is not None:
        is_tree = np.asarray([bool(macro.get(c, False)) for c in codes])
        tb = is_tree[big]
        from scipy.spatial.distance import pdist, squareform

        d = squareform(pdist(cent_big))
        d[tb[:, None] != tb[None, :]] = d.max() * 1000.0
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform as sq

        lab_big = fcluster(linkage(sq(d, checks=False), method="ward"),
                           t=kk, criterion="maxclust") - 1
    else:
        is_tree = None
        lab_big = ward_cluster(cent_big, kk)

    seg_ids = np.unique(lab_big)
    clcent = np.stack([cent_big[lab_big == s].mean(0) for s in seg_ids])
    seg_macro = {}
    if macro is not None:
        tb = is_tree[big]
        seg_macro = {int(s): bool(tb[lab_big == s].mean() >= 0.5)
                     for s in seg_ids}

    # EVT -> segment: big from the cut; rare to the nearest (same-macro)
    # cluster centroid
    evt_group: Dict = {}
    big_codes = codes[big]
    for j, c in enumerate(big_codes):
        evt_group[c] = int(lab_big[j])
    for j, c in enumerate(codes):
        if c in evt_group:
            continue
        cand = np.arange(len(seg_ids))
        if macro is not None:
            want = bool(macro.get(c, False))
            m = np.asarray([seg_macro[int(s)] == want for s in seg_ids])
            if m.any():
                cand = cand[m]
        d2 = ((clcent[cand] - cent[j]) ** 2).sum(1)
        evt_group[c] = int(seg_ids[cand[int(np.argmin(d2))]])

    # segment centroids from the plots, then nearest-centroid assignment
    grp0 = np.asarray([evt_group[c] for c in evt])
    glev = np.unique(grp0)
    gc = np.stack([z[grp0 == g].mean(0) for g in glev])
    d2 = ((z[:, None, :] - gc[None]) ** 2).sum(-1)
    segments = glev[np.argmin(d2, axis=1)]

    cohesion, frac_single = evt_cohesion(evt, segments)
    out = {"segments": segments, "evt_group": evt_group,
           "seg_macro": seg_macro, "cohesion": cohesion,
           "frac_single_segment": frac_single}
    if macro is not None:
        plot_macro = np.asarray([bool(macro.get(c, False)) for c in evt])
        seg_m = np.asarray([seg_macro.get(int(s), False)
                            for s in segments])
        out["leakage"] = float((plot_macro != seg_m).mean())
    return out


def evt_cohesion(evt: np.ndarray, segments: np.ndarray
                 ) -> Tuple[float, float]:
    """(plot-weighted cohesion: plots in their EVT's modal segment;
    fraction of EVTs entirely within one segment) -- the notebook's
    'EVT cohesion under location-based assignment' metrics."""
    evt = np.asarray(evt)
    segments = np.asarray(segments)
    codes = np.unique(evt)
    modal = 0
    single = 0
    for c in codes:
        seg_c = segments[evt == c]
        _, counts = np.unique(seg_c, return_counts=True)
        modal += counts.max()
        single += int(len(counts) == 1)
    return modal / len(evt), single / len(codes)


def write_strata_boxplot(y: np.ndarray, labels_by_method: Dict[str, np.ndarray],
                         path) -> None:
    """Removals-by-stratum boxplot sheet: one facet per stratification
    method, y-axis log1p(removals) shared across facets (the Rmd's
    strata-boxplot chunk, fia_removals_stratification.Rmd:345-380 -- the
    response is zero-inflated and right-skewed, so log1p keeps the boxes
    legible; a method separates removals well when its boxes sit at
    visibly different levels)."""
    plt = pyplot(str(path))
    if plt is None:
        return
    y = np.asarray(y, np.float64)
    methods = list(labels_by_method)
    ncol = min(3, len(methods))
    nrow = -(-len(methods) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 3.4 * nrow),
                             squeeze=False, sharey=True)
    ly = np.log1p(np.maximum(y, 0.0))
    for ax, name in zip(axes.ravel(), methods):
        lab = np.asarray(labels_by_method[name])
        groups = [ly[lab == s] for s in np.unique(lab)]
        ax.boxplot(groups, showfliers=False)
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("stratum", fontsize=8)
        ax.set_ylabel("log1p(response)", fontsize=8)
    for ax in axes.ravel()[len(methods):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def write_report_tables(out: Dict, report_dir) -> list:
    """Write the analysis result as CSV + markdown report artifacts.

    The reference ships these as rendered R-notebook tables
    (fia_removals_stratification.Rmd:320-344 efficiency table with
    within_sd / RE-vs-auxiliary / ess columns;
    fia_embedding_evaluation.Rmd section-1 probe table); this produces the
    equivalent file artifacts from the ported estimators. Returns the
    written paths.
    """
    import csv as _csv
    import math
    from pathlib import Path

    d = Path(report_dir)
    d.mkdir(parents=True, exist_ok=True)
    analysis = out.get("analysis", "analysis")
    table = out.get("table")
    if isinstance(table, dict) and table and all(
            "within_var" in r for r in table.values()):
        # removals efficiency table (Rmd:320-344): derive within_sd and
        # the relative-efficiency column vs the auxiliary (TCC-role)
        # baseline when present, else vs the units-only baseline.
        ref_row = table.get("aux_dh") or table.get("baseline") or {}
        v_ref = float(ref_row.get("within_var", 0.0))
        rows = [{
            "stratification": name,
            "within_var": round(float(r["within_var"]), 4),
            "within_sd": round(math.sqrt(max(float(r["within_var"]), 0.0)),
                               4),
            "pct_of_baseline": round(float(r["pct_of_baseline"]), 1),
            "re_vs_aux": round(v_ref / max(float(r["within_var"]), 1e-30),
                               3) if v_ref > 0 else "",
            "ess": round(float(r["ess"]), 1),
        } for name, r in table.items()]
        stem = "removals_efficiency"
    elif isinstance(table, dict) and table:
        cols = sorted({c for r in table.values() for c in r})
        rows = [{"block": name,
                 **{c: table[name].get(c, "") for c in cols}}
                for name in table]
        stem = f"{analysis}_table"
    else:
        # single-row strata-comparison summary (hierarchical / hdbscan)
        rows = [{k: v for k, v in out.items()
                 if not isinstance(v, (dict, list))}]
        stem = f"{analysis}_summary"

    cols = list(rows[0])
    csv_path = d / f"{stem}.csv"
    with open(csv_path, "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    md_path = d / f"{stem}.md"
    fmt = [[str(r[c]) for c in cols] for r in rows]
    md = ["| " + " | ".join(cols) + " |",
          "| " + " | ".join("---" for _ in cols) + " |"]
    md += ["| " + " | ".join(vals) + " |" for vals in fmt]
    md_path.write_text(f"# {analysis} report ({out.get('n_plots', '?')} "
                       f"plots)\n\n" + "\n".join(md) + "\n")
    return [csv_path, md_path]


def main(argv=None):
    """CLI over an embeddings CSV (embed_locations output schema:
    z_type_* / z_phase_* columns + a target column): run the requested
    stratification analysis and print the efficiency table as JSON.

    Run: python -m forest_tpu_torch.eval.fia --csv emb.csv --target BALIVE
            --analysis {hierarchical,hdbscan,removals,probe_table}
            [--report-dir DIR]   # write CSV + markdown table artifacts
            [--device cuda]      # where HDBSCAN and k-means run
    """
    import argparse
    import csv as _csv
    import json

    from forest_tpu_torch.eval.frozen import resolve_device

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--target", required=True,
                    help="target column name (e.g. BALIVE)")
    ap.add_argument("--analysis", default="hierarchical",
                    choices=["hierarchical", "hdbscan", "removals",
                             "probe_table"])
    ap.add_argument("--transfer-target", default=None,
                    help="column for the transfer/shared stratification")
    ap.add_argument("--unit-col", default=None,
                    help="survey-unit column (UNITCD role)")
    ap.add_argument("--aux-col", default=None,
                    help="auxiliary covariate column (TCC role)")
    ap.add_argument("--k-type", type=int, default=20)
    ap.add_argument("--k-phase", type=int, default=3)
    ap.add_argument("--k-strata", type=int, default=5)
    ap.add_argument("--phase-subdivide-frac", type=float, default=0.25)
    ap.add_argument("--output", default=None,
                    help="optional .npz for stratum labels")
    ap.add_argument("--report-dir", dest="report_dir", default=None,
                    help="write CSV + markdown table artifacts here "
                         "(the Rmd notebooks' rendered tables)")
    ap.add_argument("--device", default="cuda",
                    help="where HDBSCAN and k-means run (default: cuda)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    with open(a.csv) as f:
        recs = list(_csv.DictReader(f))
    if not recs:
        raise SystemExit("empty CSV")
    # Drop rows embed_locations marked invalid (points outside the cube
    # write only index/valid; DictWriter pads every other column with '').
    def usable(r):
        if r.get("valid", "1").strip() in ("0", ""):
            return False
        if r.get(a.target, "").strip() == "":
            return False
        return all(v.strip() != "" for k, v in r.items()
                   if k.startswith(("z_type_", "z_phase_")))
    n_all = len(recs)
    recs = [r for r in recs if usable(r)]
    if not recs:
        raise SystemExit(
            f"no usable rows in {a.csv}: all {n_all} rows are invalid "
            f"(valid=0) or missing {a.target!r}/embedding values")
    if len(recs) < n_all:
        import sys
        print(f"[fia] skipped {n_all - len(recs)}/{n_all} rows with "
              "valid=0 or blank embedding/target cells", file=sys.stderr)

    def cols(prefix):
        names = sorted((k for k in recs[0] if k.startswith(prefix)),
                       key=lambda s: int(s[len(prefix):]))
        return np.asarray([[float(r[k]) for k in names] for r in recs])

    z_type = cols("z_type_")
    z_phase = cols("z_phase_") if any(
        k.startswith("z_phase_") for k in recs[0]) else None
    y = np.asarray([float(r[a.target]) for r in recs])
    units = (np.asarray([r[a.unit_col] for r in recs])
             if a.unit_col else None)
    out: Dict = {"analysis": a.analysis, "n_plots": len(y)}

    if a.analysis == "hierarchical":
        if z_phase is None:
            raise SystemExit("hierarchical needs z_phase_* columns")
        res = hierarchical_type_phase_strata(
            z_type, z_phase, y, a.k_type, a.phase_subdivide_frac,
            a.k_phase, a.k_strata)
        strata = res["stratum"]
        v_base = pooled_within_variance(
            y, units if units is not None else np.zeros(len(y)))
        v = pooled_within_variance(
            y, units if units is not None else np.zeros(len(y)), strata)
        out.update(k_type_bins=int(res["type_bin"].max() + 1),
                   n_fine_bins=int(len(np.unique(res["fine_bin"]))),
                   subdivided=[int(b) for b in res["subdivided"]],
                   within_var=v, baseline_var=v_base,
                   pct_of_baseline=100.0 * v / max(v_base, 1e-30))
        labels = strata
    elif a.analysis == "hdbscan":
        rep = density_strata_report(z_type, y, units, a.k_type, a.k_strata,
                                    device=device)
        out.update(within_var=rep["within_var"],
                   baseline_var=rep["baseline_var"],
                   pct_of_baseline=rep["pct_of_baseline"],
                   ess=rep["ess"], hdbscan_k=rep["hdbscan"]["k"],
                   min_pts=rep["hdbscan"]["min_pts"],
                   noise_frac=rep["hdbscan"]["noise_frac"])
        labels = rep["stratum"]
    elif a.analysis == "removals":
        z_all = (np.concatenate([z_type, z_phase], 1)
                 if z_phase is not None else z_type)
        transfer = (np.asarray([float(r[a.transfer_target])
                                for r in recs])
                    if a.transfer_target else None)
        aux = (np.asarray([float(r[a.aux_col]) for r in recs])
               if a.aux_col else None)
        rows, strata_labels = removals_stratification_report(
            z_type, z_all, y, transfer, units, aux, a.k_strata,
            return_labels=True, device=device)
        out["table"] = rows
        labels = strata_labels["emb_sup"]
        if a.report_dir:
            from pathlib import Path as _P
            d = _P(a.report_dir)
            d.mkdir(parents=True, exist_ok=True)
            write_strata_boxplot(y, strata_labels, d / "strata_boxplot.png")
    else:  # probe_table
        blocks = {"z_type": z_type}
        if z_phase is not None:
            blocks["z_phase"] = z_phase
            blocks["z_type+z_phase"] = np.concatenate(
                [z_type, z_phase], 1)
        out["table"] = linear_probe_table(blocks, y)
        labels = None

    if a.output and labels is not None:
        np.savez(a.output, stratum=labels)
    if a.report_dir:
        for p in write_report_tables(out, a.report_dir):
            import sys
            print(f"[fia] wrote {p}", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()


__all__ = ["post_stratified_estimate", "simple_random_estimate",
           "relative_efficiency", "embedding_strata", "knn_impute",
           "ward_cluster", "dh_strata", "pooled_within_variance",
           "aggregate_bins_by_target", "apply_bin_map",
           "oof_linear_scores", "hierarchical_type_phase_strata",
           "assign_noise_to_nearest", "hdbscan_strata",
           "density_strata_report", "removals_stratification_report",
           "adjusted_r2", "linear_probe_table", "blockwise_l2_normalize",
           "knn_eval", "tune_phase_weight_and_k", "error_by_strata",
           "response_by_recovery_class", "evt_centroid_segments",
           "evt_cohesion", "write_report_tables", "write_strata_boxplot",
           "main"]
