"""GMM clustering tools over embeddings.

Port of ``forest_tpu/eval/gmm.py`` over the port's own estimators
(:mod:`forest_tpu_torch.eval.cluster`, in place of scikit-learn's), which
fit on ``device``:

- fit_gmm_clusters (original: frl/training/fit_gmm_clusters.py): GMM on
  reservoir-sampled z_type with BIC/AIC model selection over a component
  range;
- compare_gmm_evt (compare_gmm_evt.py): cluster x EVT contingency table,
  NMI and purity;
- fit_landscape_categories (fit_landscape_categories.py): hierarchical
  categories -- type clusters, then per-type phase clusters split into
  disturbed/recovered centroids.

Run: python -m forest_tpu_torch.eval.gmm --checkpoint CKPT --bindings B.yaml
        --output OUT.npz [--components 4 8 16] [--evt-source g.c]
        [--device cuda]
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from forest_tpu_torch.data.samplers import ReservoirSampler
from forest_tpu_torch.eval.cluster import (GaussianMixture,
                                           normalized_mutual_info_score)


def reservoir_sample_embeddings(batches, capacity: int = 100_000,
                                seed: int = 0) -> np.ndarray:
    """batches: iterable of ([N, D] array, valid [N]) -> [<=cap, D]."""
    rs = ReservoirSampler(capacity, seed=seed)
    for z, valid in batches:
        z = np.asarray(z)
        rs.add(z[np.asarray(valid, bool)])
    return rs.sample()


def fit_gmm_clusters(z: np.ndarray,
                     n_components_range: Sequence[int] = (4, 8, 16, 24, 32),
                     covariance_type: str = "diag", seed: int = 0,
                     device="cuda") -> Dict:
    """Fit GMMs across a component range on ``device``; select by BIC."""
    results = []
    best = None
    for k in n_components_range:
        gm = GaussianMixture(n_components=k,
                             covariance_type=covariance_type,
                             random_state=seed, max_iter=200, device=device)
        gm.fit(z)
        entry = {"k": k, "bic": float(gm.bic(z)), "aic": float(gm.aic(z)),
                 "model": gm}
        results.append(entry)
        if best is None or entry["bic"] < best["bic"]:
            best = entry
    return {"results": results, "best": best, "n_samples": len(z)}


def cluster_evt_contingency(labels: np.ndarray, evt: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (table [n_clusters, n_codes], cluster ids, evt codes)."""
    cl = np.unique(labels)
    codes = np.unique(evt)
    table = np.zeros((len(cl), len(codes)), np.int64)
    ci = np.searchsorted(cl, labels)
    ei = np.searchsorted(codes, evt)
    np.add.at(table, (ci, ei), 1)
    return table, cl, codes


def compare_gmm_evt(labels: np.ndarray, evt: np.ndarray) -> Dict:
    """NMI + purity of GMM clusters against EVT codes."""
    valid = evt >= 0
    labels, evt = labels[valid], evt[valid]
    table, cl, codes = cluster_evt_contingency(labels, evt)
    purity = float(table.max(axis=1).sum() / max(table.sum(), 1))
    nmi = float(normalized_mutual_info_score(evt, labels))
    return {"nmi": nmi, "purity": purity, "contingency": table,
            "cluster_ids": cl, "evt_codes": codes}


def fit_landscape_categories(z_type: np.ndarray, z_phase: np.ndarray,
                             ysfc: np.ndarray, n_type_clusters: int = 8,
                             n_phase_clusters: int = 2,
                             disturbed_max: float = 5.0, seed: int = 0,
                             device="cuda") -> Dict:
    """Hierarchical categories: GMM on z_type; within each type cluster,
    GMM on z_phase with disturbed (ysfc <= disturbed_max) vs recovered
    centroids (fit_landscape_categories.py contract).

    z_type [N, zt]; z_phase [N, zp] (a representative timestep per pixel);
    ysfc [N] the matching ysfc value.
    """
    gm_type = GaussianMixture(n_components=n_type_clusters,
                              covariance_type="diag", random_state=seed,
                              device=device)
    type_labels = gm_type.fit_predict(z_type)

    per_type = {}
    for t in range(n_type_clusters):
        sel = type_labels == t
        entry = {"n": int(sel.sum())}
        if sel.sum() >= 2 * n_phase_clusters:
            gm_p = GaussianMixture(n_components=n_phase_clusters,
                                   covariance_type="diag",
                                   random_state=seed, device=device)
            pl = gm_p.fit_predict(z_phase[sel])
            entry["phase_labels"] = pl
            entry["phase_means"] = gm_p.means_
        dist = sel & np.asarray(ysfc <= disturbed_max)
        rec = sel & np.asarray(ysfc > disturbed_max)
        entry["disturbed_centroid"] = (z_phase[dist].mean(0)
                                       if dist.any() else None)
        entry["recovered_centroid"] = (z_phase[rec].mean(0)
                                       if rec.any() else None)
        per_type[t] = entry
    return {"type_model": gm_type, "type_labels": type_labels,
            "per_type": per_type}


def main(argv=None):
    """CLI (fit_gmm_clusters.py role): stream a split through the frozen
    type encoder on the device, reservoir-sample valid-pixel embeddings on
    the host, BIC-sweep GMMs on the device, optionally score clusters
    against EVT codes; writes labels + summary.

    Run: python -m forest_tpu_torch.eval.gmm --checkpoint CKPT
            --bindings B.yaml --output OUT.npz [--components 4 8 16]
            [--evt-source g.c] [--device cuda]
    """
    import argparse
    import json

    import torch

    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--output", required=True, help=".npz output path")
    ap.add_argument("--split", default="train")
    ap.add_argument("--split-block-size", type=int, nargs=2, default=(4, 4))
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--components", type=int, nargs="+",
                    default=(4, 8, 16, 24, 32))
    ap.add_argument("--capacity", type=int, default=100_000)
    ap.add_argument("--covariance-type", default="diag")
    ap.add_argument("--evt-source", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the fits run (default: cuda)")
    a = ap.parse_args(argv)

    device = frozen.resolve_device(a.device)
    bindings = parse_bindings(a.bindings)
    fb = FeatureBuilder(bindings)
    ds = ForestDatasetV2(bindings, split=a.split, patch_size=a.patch_size,
                         split_block_size=tuple(a.split_block_size))
    frozen.require_patches(ds, a.split, a.patch_size, a.split_block_size)
    model = frozen.load_frozen_model(a.checkpoint, device)
    enc_t, _, _ = frozen.make_encode_fns(model, fb)

    def batches():
        n = len(ds)
        count = 0
        for i in range(0, n, a.batch_size):
            idx = list(range(i, min(i + a.batch_size, n)))
            batch = frozen.batch_to_device(ds.load_batch(idx), device)
            z = enc_t(batch)
            _, m = fb.build_feature("type_encoder_input", batch)
            cols = [z.reshape(-1, z.shape[-1]).float()]
            if a.evt_source:
                g, c = a.evt_source.split(".")
                gc = fb.bindings.dataset[g]
                cols.append(batch[g][..., gc.channel_index(c)]
                            .reshape(-1, 1).float())
            yield (torch.cat(cols, 1).cpu().numpy(),
                   m.all(-1).reshape(-1).cpu().numpy())
            count += 1
            if a.max_batches and count >= a.max_batches:
                break

    buf = reservoir_sample_embeddings(batches(), a.capacity, a.seed)
    z = buf[:, :model.z_type_dim]
    res = fit_gmm_clusters(z, a.components, a.covariance_type, a.seed,
                           device)
    labels = res["best"]["model"].predict(z)
    summary = {"best_k": res["best"]["k"],
               "bic": {r["k"]: r["bic"] for r in res["results"]},
               "aic": {r["k"]: r["aic"] for r in res["results"]},
               "n_samples": res["n_samples"]}
    save = {"labels": labels, "z_type": z,
            "means": res["best"]["model"].means_}
    if a.evt_source:
        evt = buf[:, -1].astype(np.int64)
        cmp = compare_gmm_evt(labels, evt)
        summary["nmi"] = cmp["nmi"]
        summary["purity"] = cmp["purity"]
        save["evt"] = evt
    np.savez(a.output, **save)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()


__all__ = ["reservoir_sample_embeddings", "fit_gmm_clusters",
           "compare_gmm_evt", "cluster_evt_contingency",
           "fit_landscape_categories", "main"]
