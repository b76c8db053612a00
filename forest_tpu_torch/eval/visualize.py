"""Figure sheets: test-patch probes and forest diagnostics.

Port of ``forest_tpu/eval/visualize.py``:

- visualize_test_patches (the reference's visualize_test_patches.py):
  per-patch sheets of probe predictions vs targets over test-split patches;
- visualize_forest_diagnostics (visualize_forest_diagnostics.py): smoothing
  gate maps + embedding-structure panels.

The encoders, the probes' predictions and their inverse normalisation run
on ``device`` (the type forward and the gate forward launch K1 on a card);
each patch comes to the host in one copy, where the sheets' numpy runs as
in the JAX package. Every plotting function computes what it shows first
and draws through ``utils.log.pyplot``: where matplotlib does not import,
it logs each skipped figure and returns no path.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from forest_tpu_torch.eval.frozen import (batch_to_device,
                                          make_phase_target_fn, to_host)
from forest_tpu_torch.utils import spatial as sp
from forest_tpu_torch.utils.log import pyplot


def _pca_rgb(z: np.ndarray) -> np.ndarray:
    """[H, W, D] -> [H, W, 3] PCA false-color."""
    h, w, d = z.shape
    flat = z.reshape(-1, d)
    mu = flat.mean(0)
    c = np.cov((flat - mu).T)
    _, vec = np.linalg.eigh(c)
    proj = (flat - mu) @ vec[:, -3:]
    lo, hi = np.percentile(proj, 2, 0), np.percentile(proj, 98, 0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return rgb.reshape(h, w, 3)


def _linear_probe(z: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Rows [N, D] through the closed-form probe W [D + 1, C] (its last row
    the bias), float64 on z's device."""
    w = torch.as_tensor(weights, dtype=torch.float64, device=z.device)
    return z.double() @ w[:-1] + w[-1]


def visualize_test_patches(encode_fn: Callable, fb, dataset,
                           target_feature: str,
                           probe_weights: Optional[np.ndarray],
                           out_dir: str | Path, n_patches: int = 4,
                           device="cuda") -> List[Path]:
    """Sheets: target channels vs probe predictions + z_type PCA-RGB."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(min(n_patches, len(dataset))):
        batch = batch_to_device(dataset.load_batch([i]), device)
        z = encode_fn(batch)[0]                         # [H, W, D]
        y, _ = fb.build_feature(target_feature, batch)
        got = {"z": z, "y": y[0]}
        if probe_weights is not None:
            got["pred"] = _linear_probe(z.reshape(-1, z.shape[-1]),
                                        probe_weights).reshape(y[0].shape)
        got = to_host(got)
        y, pred = got["y"], got.get("pred")
        rgb = _pca_rgb(got["z"])
        k = min(y.shape[-1], 3)
        p = out_dir / f"test_patch_{i:03d}.png"
        plt = pyplot(p.name)
        if plt is None:
            continue
        cols = 1 + k * (2 if pred is not None else 1)
        fig, axes = plt.subplots(1, cols, figsize=(3 * cols, 3.2))
        axes = np.atleast_1d(axes)
        axes[0].imshow(rgb)
        axes[0].set_title("z_type (PCA rgb)")
        for c in range(k):
            ax = axes[1 + c * (2 if pred is not None else 1)]
            im = ax.imshow(y[..., c])
            ax.set_title(f"target[{c}]")
            plt.colorbar(im, ax=ax, fraction=0.046)
            if pred is not None:
                ax2 = axes[2 + c * 2]
                im2 = ax2.imshow(pred[..., c], vmin=y[..., c].min(),
                                 vmax=y[..., c].max())
                ax2.set_title(f"probe pred[{c}]")
                plt.colorbar(im2, ax=ax2, fraction=0.046)
        for ax in axes:
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths


def visualize_forest_diagnostics(encode_gate_fn: Callable, dataset,
                                 out_dir: str | Path, n_patches: int = 4,
                                 device="cuda") -> List[Path]:
    """Gate-map sheets: z_type PCA-RGB + smoothing-gate mean + histogram."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(min(n_patches, len(dataset))):
        batch = batch_to_device(dataset.load_batch([i]), device)
        z, gate = encode_gate_fn(batch)
        got = to_host({"z": z[0], "g": gate[0].float().mean(-1)})
        g, rgb = got["g"], _pca_rgb(got["z"])
        p = out_dir / f"diagnostics_{i:03d}.png"
        plt = pyplot(p.name)
        if plt is None:
            continue
        fig, axes = plt.subplots(1, 3, figsize=(10, 3.2))
        axes[0].imshow(rgb)
        axes[0].set_title("z_type (PCA rgb)")
        im = axes[1].imshow(g, vmin=0, vmax=1, cmap="magma")
        axes[1].set_title(f"gate mean={g.mean():.3f}")
        plt.colorbar(im, ax=axes[1], fraction=0.046)
        axes[2].hist(g.ravel(), bins=40, range=(0, 1))
        axes[2].set_title("gate distribution")
        for ax in axes[:2]:
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths


def _masked(arr: np.ndarray, mask: np.ndarray) -> np.ma.MaskedArray:
    """Reference _make_masked (visualize_test_patches.py:213-216)."""
    return np.ma.MaskedArray(arr, mask=~mask)


def collect_patch_records(encode_fn: Callable, fb, dataset,
                          target_feature: str,
                          probe_weights: Optional[np.ndarray],
                          n_patches: int = 4,
                          original_scale: bool = True,
                          device="cuda") -> List[dict]:
    """Per-patch observed/predicted maps per target channel, optionally
    mapped back to the ORIGINAL data scale (reference
    visualize_test_patches.py:110-211 collect_patch_data +
    back_transform_channel)."""
    from forest_tpu_torch.eval.phase_probe import inverse_normalization_fn

    fc = fb.bindings.get_feature(target_feature)
    names = list(fc.channels.keys())
    inverse = (inverse_normalization_fn(fb, target_feature)
               if original_scale else None)
    records = []
    for i in range(min(n_patches, len(dataset))):
        batch = batch_to_device(dataset.load_batch([i]), device)
        z = encode_fn(batch)[0]
        y, ym = fb.build_feature(target_feature, batch)
        y, ym = y[0], ym[0]
        if y.dim() == 4:   # temporal target: show the last timestep sheet
            y, ym = y[-1], ym[-1]
        pred = None
        if probe_weights is not None:
            pred = _linear_probe(z.reshape(-1, z.shape[-1]),
                                 probe_weights).reshape(y.shape)
        if inverse is not None:
            h, w, c = y.shape
            y = inverse(y.reshape(-1, c)).reshape(h, w, c)
            if pred is not None:
                pred = inverse(pred.reshape(-1, c)).reshape(h, w, c)
        got = {"combined_mask": ym.all(-1), "z_type": z, "y": y}
        if pred is not None:
            got["pred"] = pred
        got = to_host(got)
        rec = {"combined_mask": got["combined_mask"],
               "z_type": got["z_type"]}
        for ci, name in enumerate(names):
            rec[f"target_{name}"] = got["y"][..., ci]
            if pred is not None:
                rec[f"pred_{name}"] = got["pred"][..., ci]
        records.append(rec)
    return records


def plot_variable_sheets(records: List[dict], channel_names: List[str],
                         out_dir: str | Path,
                         max_cols: int = 4) -> List[Path]:
    """One figure per variable: observed/predicted tile grid with global
    2-98 percentile color limits, masked pixels, shared colorbar
    (reference plot_variable_sheet :218-296)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in channel_names:
        has_pred = f"pred_{name}" in records[0]
        n = len(records)
        n_cols = min(max_cols, n)
        n_rows = -(-n // n_cols) * (2 if has_pred else 1)
        vals = np.concatenate(
            [r[f"target_{name}"][r["combined_mask"]].ravel()
             for r in records if r["combined_mask"].any()] or
            [np.zeros(1)])
        vmin, vmax = (float(np.nanpercentile(vals, 2)),
                      float(np.nanpercentile(vals, 98)))
        p = out_dir / f"sheet_{name.replace('.', '_')}.png"
        plt = pyplot(p.name)
        if plt is None:
            continue
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(3.2 * n_cols, 3.0 * n_rows),
                                 squeeze=False)
        im = None
        for i, rec in enumerate(records):
            rb, col = divmod(i, n_cols)
            rows = ([rb * 2, rb * 2 + 1] if has_pred else [rb])
            panels = [("Obs", rec[f"target_{name}"])]
            if has_pred:
                panels.append(("Pred", rec[f"pred_{name}"]))
            for (label, arr), rr in zip(panels, rows):
                ax = axes[rr, col]
                im = ax.imshow(_masked(arr, rec["combined_mask"]),
                               vmin=vmin, vmax=vmax, cmap="viridis",
                               interpolation="nearest")
                ax.set_title(f"{label} #{i}", fontsize=8)
                ax.set_xticks([])
                ax.set_yticks([])
        for r in range(n_rows):
            for c in range(n_cols):
                if (r // (2 if has_pred else 1)) * n_cols + c >= n:
                    axes[r, c].axis("off")
        fig.suptitle(f"{name}  (observed vs predicted, original scale)",
                     fontsize=11)
        fig.tight_layout(rect=(0, 0, 0.92, 0.96))
        fig.colorbar(im, cax=fig.add_axes((0.93, 0.08, 0.015, 0.84)))
        fig.savefig(p, dpi=130, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)
    return paths


def plot_gate_channel_sheets(encode_gate_fn: Callable, dataset,
                             out_dir: str | Path, n_patches: int = 4,
                             top_k: int = 6, device="cuda") -> List[Path]:
    """Per-channel gate maps for the top-variance gate channels, one row
    per patch (reference plot_gate_channels :346-420 with the
    _select_gate_channels variance ranking :298-344)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gates, n = [], min(n_patches, len(dataset))
    for i in range(n):
        batch = batch_to_device(dataset.load_batch([i]), device)
        _, gate = encode_gate_fn(batch)
        gates.append(to_host({"g": gate[0]})["g"])      # [H, W, G]
    g_all = np.stack(gates)                              # [N, H, W, G]
    var = g_all.reshape(-1, g_all.shape[-1]).var(0)
    chans = np.argsort(var)[::-1][:min(top_k, g_all.shape[-1])]
    p = out_dir / "gate_channels.png"
    plt = pyplot(p.name)
    if plt is None:
        return []
    fig, axes = plt.subplots(n, len(chans),
                             figsize=(2.6 * len(chans), 2.6 * n),
                             squeeze=False)
    im = None
    for r in range(n):
        for c, ch in enumerate(chans):
            ax = axes[r, c]
            im = ax.imshow(g_all[r, :, :, ch], vmin=0, vmax=1,
                           cmap="magma", interpolation="nearest")
            if r == 0:
                ax.set_title(f"gate[{ch}] var={var[ch]:.3f}", fontsize=8)
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle("smoothing gate channels (top variance)", fontsize=11)
    fig.tight_layout(rect=(0, 0, 0.92, 0.96))
    fig.colorbar(im, cax=fig.add_axes((0.93, 0.08, 0.015, 0.84)))
    fig.savefig(p, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [p]


def _load_temporal_channel(fb, dataset, feature, channel, patch_idx):
    """-> (y [T,H,W], mask [T,H,W]) for one channel of one patch (built on
    the host)."""
    batch = batch_to_device(dataset.load_batch([patch_idx]), "cpu")
    y, ym = fb.build_feature(feature, batch)
    ci = list(fb.bindings.get_feature(feature).channels.keys()).index(
        channel)
    return y[0][..., ci].numpy(), ym[0][..., ci].numpy()


def _year_tile_sheet(data, mask, vmin, vmax, cmap, title, out_path,
                     max_years):
    """Shared per-year tile scaffolding (grid, masks, colorbar, save)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt = pyplot(out_path.name)
    if plt is None:
        return []
    t = min(data.shape[0], max_years)
    fig, axes = plt.subplots(1, t, figsize=(2.4 * t, 2.8), squeeze=False)
    im = None
    for ti in range(t):
        ax = axes[0, ti]
        im = ax.imshow(_masked(data[ti], mask[ti]), vmin=vmin, vmax=vmax,
                       cmap=cmap, interpolation="nearest")
        ax.set_title(f"t={ti}", fontsize=7)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle(title, fontsize=11)
    fig.tight_layout(rect=(0, 0, 0.92, 0.94))
    fig.colorbar(im, cax=fig.add_axes((0.93, 0.1, 0.015, 0.8)))
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [out_path]


def plot_variable_timeseries(fb, dataset, feature: str, channel: str,
                             out_dir: str | Path, patch_idx: int = 0,
                             max_years: int = 8) -> List[Path]:
    """Per-year tiles of one temporal channel for one patch (reference
    visualize_forest_diagnostics.py:298-398 plot_variable_timeseries)."""
    y, m = _load_temporal_channel(fb, dataset, feature, channel, patch_idx)
    vals = y[m] if m.any() else np.zeros(1)
    return _year_tile_sheet(
        y, m, float(np.nanpercentile(vals, 2)),
        float(np.nanpercentile(vals, 98)), "viridis",
        f"{channel} over time (patch {patch_idx})",
        Path(out_dir) / f"timeseries_{channel.replace('.', '_')}.png",
        max_years)


def plot_variable_anomaly(fb, dataset, feature: str, channel: str,
                          out_dir: str | Path, patch_idx: int = 0,
                          max_years: int = 8) -> List[Path]:
    """Temporal-anomaly tiles: per-year deviation from each pixel's
    temporal mean, so the color scale shows CHANGE rather than spatial
    structure (reference visualize_forest_diagnostics.py:400-515)."""
    y, m = _load_temporal_channel(fb, dataset, feature, channel, patch_idx)
    cnt = np.maximum(m.sum(0), 1)
    mu = (np.where(m, y, 0.0)).sum(0) / cnt              # [H, W]
    anom = np.where(m, y - mu[None], np.nan)
    lim = float(np.nanpercentile(np.abs(anom), 98)) if m.any() else 1.0
    if not np.isfinite(lim) or lim == 0.0:
        lim = 1.0
    return _year_tile_sheet(
        anom, m, -lim, lim, "RdBu_r",
        f"{channel} temporal anomaly (patch {patch_idx})",
        Path(out_dir) / f"anomaly_{channel.replace('.', '_')}.png",
        max_years)


def plot_ysfc_map(dataset, ysfc_source: str, out_dir: str | Path,
                  n_patches: int = 4) -> List[Path]:
    """Min-over-time years-since-fast-change maps (reference
    visualize_forest_diagnostics.py:517-563 plot_ysfc_map)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gname, cname = ysfc_source.split(".")
    n = min(n_patches, len(dataset))
    maps = []
    for i in range(n):
        batch = dataset.load_batch([i])
        gcfg = dataset.bindings.dataset[gname]
        ys = np.asarray(batch[gname][0][..., gcfg.channel_index(cname)],
                        np.float32)                      # [T, H, W]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            maps.append(np.nanmin(ys, axis=0))
    p = out_dir / "ysfc_map.png"
    plt = pyplot(p.name)
    if plt is None:
        return []
    fig, axes = plt.subplots(1, n, figsize=(2.8 * n, 3.0), squeeze=False)
    im = None
    for i, ys_min in enumerate(maps):
        ax = axes[0, i]
        im = ax.imshow(ys_min, cmap="cividis", interpolation="nearest")
        ax.set_title(f"#{i} median={np.nanmedian(ys_min):.1f}", fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle("ysfc_min (years since fast change)", fontsize=11)
    fig.tight_layout(rect=(0, 0, 0.92, 0.94))
    fig.colorbar(im, cax=fig.add_axes((0.93, 0.1, 0.015, 0.8)))
    fig.savefig(p, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [p]


# ---------------------------------------------------------------------------
# Forest-diagnostics sheet family: ysfc-ranked patches, obs-vs-PREDICTED
# temporal sheets via the phase probe, anomaly sheets, masked ysfc_min maps
# -- the reference's visualize_forest_diagnostics.py:63-563.
# ---------------------------------------------------------------------------

def _static_mask(dataset, batch, sources: List[str], shape) -> np.ndarray:
    """AND of static mask channels like 'static_mask.forest'; missing
    sources are skipped (small demo cubes may lack a forest mask)."""
    m = np.ones(shape, bool)
    for src in sources:
        try:
            g, c = src.split(".")
            gc = dataset.bindings.dataset[g]
            m &= np.asarray(batch[g][0][..., gc.channel_index(c)]) > 0
        except (KeyError, ValueError):
            continue
    return m


def _ysfc_min(dataset, batch, ysfc_source: str) -> np.ndarray:
    g, c = ysfc_source.split(".")
    gc = dataset.bindings.dataset[g]
    ys = np.asarray(batch[g][0][..., gc.channel_index(c)], np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.nanmin(ys, axis=0)


def rank_patches_by_ysfc(dataset, ysfc_source: str = "annual.ysfc",
                         mask_sources: (List[str] | None) = None,
                         threshold: float = 10.0,
                         max_patches: Optional[int] = None
                         ) -> List[tuple]:
    """(patch_idx, count of masked pixels with ysfc_min < threshold),
    sorted descending -- the reference's disturbance-first patch
    selection (visualize_forest_diagnostics.py:76-116)."""
    mask_sources = mask_sources if mask_sources is not None else \
        ["static_mask.aoi", "static_mask.forest"]
    counts = []
    n = len(dataset) if max_patches is None else min(max_patches,
                                                     len(dataset))
    for i in range(n):
        batch = dataset.load_batch([i])
        ys_min = _ysfc_min(dataset, batch, ysfc_source)
        valid = _static_mask(dataset, batch, mask_sources, ys_min.shape)
        valid &= np.isfinite(ys_min)
        counts.append((i, int((valid & (ys_min < threshold)).sum())))
    counts.sort(key=lambda x: x[1], reverse=True)
    return counts


def collect_forest_diag_records(encode_type_fn, encode_phase_fn, fb,
                                dataset, patch_indices: List[int],
                                probe_w: np.ndarray, preprocessor,
                                target_feature: str,
                                ysfc_source: str = "annual.ysfc",
                                mask_sources: (List[str] | None) = None,
                                device="cuda") -> List[dict]:
    """Observed + probe-PREDICTED [T, H, W] maps per target channel for
    the selected patches, back-transformed to the original data scale
    (visualize_forest_diagnostics.py:117-290 collect_phase_diagnostics).
    The phase forward at every pixel, the design matrix, the probe and the
    inverse normalisation run on ``device``."""
    from forest_tpu_torch.eval.phase_probe import (inverse_normalization_fn,
                                                   predict_phase_probe)

    mask_sources = mask_sources if mask_sources is not None else \
        ["static_mask.aoi", "static_mask.forest"]
    names = list(fb.bindings.get_feature(target_feature).channels.keys())
    inverse = inverse_normalization_fn(fb, target_feature)
    targets_fn = make_phase_target_fn(fb, target_feature)
    records = []
    for idx in patch_indices:
        host = dataset.load_batch([idx])
        batch = batch_to_device(host, device)
        zt = encode_type_fn(batch)                         # [1, H, W, zt]
        h, w = zt.shape[1:3]
        rr, cc = torch.meshgrid(torch.arange(h, device=zt.device),
                                torch.arange(w, device=zt.device),
                                indexing="ij")
        coords = torch.stack([rr.reshape(-1), cc.reshape(-1)], 1)
        zp = encode_phase_fn(batch, coords)[0]             # [HW, T, zp]
        ta, tm = targets_fn(batch, coords)                 # [1,HW,T,C]
        zt_a = sp.extract_at_locations(zt, coords[None])[0]  # [HW, zt]
        hw, t, dp = zp.shape
        zt_rep = zt_a[:, None, :].expand(hw, t, zt.shape[-1])
        pred = predict_phase_probe(probe_w, preprocessor,
                                   zt_rep.reshape(hw * t, -1),
                                   zp.reshape(hw * t, dp))  # [HW*T, C]
        got = to_host({
            "pred": inverse(pred).reshape(hw, t, -1),
            "obs": inverse(ta[0].reshape(hw * t, -1)).reshape(hw, t, -1),
            "tmask": tm[0].all(-1).reshape(hw, t)})
        pred, obs = got["pred"], got["obs"]
        spatial_ok = got["tmask"].all(-1).reshape(h, w)
        mask = _static_mask(dataset, host, mask_sources, (h, w))
        ys_min = _ysfc_min(dataset, host, ysfc_source)
        rec = {"patch_idx": idx, "T": t,
               "combined_mask": mask & spatial_ok,
               "aoi_forest_mask": mask, "ysfc_min": ys_min}
        for ci, name in enumerate(names):
            rec[f"target_{name}"] = np.moveaxis(
                obs[:, :, ci].reshape(h, w, t), -1, 0)     # [T, H, W]
            rec[f"pred_{name}"] = np.moveaxis(
                pred[:, :, ci].reshape(h, w, t), -1, 0)
        records.append(rec)
    return records


def _diag_sheet(records: List[dict], channel: str, years: List[int],
                out_path: Path, anomaly: bool) -> Optional[Path]:
    """Rows = patch x (obs, pred); columns = year. Plain values with a
    global 2-98 viridis scale, or per-pixel temporal anomalies with a
    symmetric RdBu_r scale (reference :298-515)."""
    n_p = len(records)
    t = records[0]["T"]
    panels, vals = [], []
    for rec in records:
        mask = rec["combined_mask"]
        obs = rec[f"target_{channel}"]
        pred = rec[f"pred_{channel}"]
        if anomaly:
            obs = np.where(mask[None], obs, np.nan)
            pred = np.where(mask[None], pred, np.nan)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # all-masked pixels
                obs = obs - np.nanmean(obs, axis=0, keepdims=True)
                pred = pred - np.nanmean(pred, axis=0, keepdims=True)
        panels.append((obs, pred, mask))
        v = obs[:, mask].ravel()
        vals.append(v[np.isfinite(v)])
        if anomaly:
            v = pred[:, mask].ravel()
            vals.append(v[np.isfinite(v)])
    allv = np.concatenate([v for v in vals if v.size] or [np.zeros(1)])
    if anomaly:
        lim = float(np.nanpercentile(np.abs(allv), 98)) or 1.0
        vmin, vmax, cmap = -lim, lim, "RdBu_r"
    else:
        vmin = float(np.nanpercentile(allv, 2))
        vmax = float(np.nanpercentile(allv, 98))
        cmap = "viridis"
    out_path = Path(out_path)
    plt = pyplot(out_path.name)
    if plt is None:
        return None
    fig, axes = plt.subplots(n_p * 2, t,
                             figsize=(1.8 * t, 1.8 * n_p * 2),
                             squeeze=False)
    im = None
    for p_idx, (rec, (obs, pred, mask)) in enumerate(zip(records,
                                                         panels)):
        for ti in range(t):
            for rr, arr in ((p_idx * 2, obs), (p_idx * 2 + 1, pred)):
                ax = axes[rr, ti]
                im = ax.imshow(_masked(arr[ti], mask), vmin=vmin,
                               vmax=vmax, cmap=cmap,
                               interpolation="nearest")
                ax.set_xticks([])
                ax.set_yticks([])
            if p_idx == 0:
                axes[0, ti].set_title(
                    str(years[ti] if ti < len(years) else ti), fontsize=7)
        n_dist = int((rec["aoi_forest_mask"]
                      & np.isfinite(rec["ysfc_min"])
                      & (rec["ysfc_min"] < 10)).sum())
        axes[p_idx * 2, 0].set_ylabel(
            f"P{rec['patch_idx']} Obs\n(ysfc<10: {n_dist})", fontsize=6)
        axes[p_idx * 2 + 1, 0].set_ylabel("Pred", fontsize=6)
    kind = ("temporal anomaly: deviation from pixel mean" if anomaly
            else "observed vs predicted, original scale")
    fig.suptitle(f"{channel}  ({kind})", fontsize=11)
    fig.tight_layout(rect=(0, 0, 0.94, 0.96))
    if im is not None:
        fig.colorbar(im, cax=fig.add_axes((0.95, 0.08, 0.012, 0.84)))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_forest_diag_sheets(records: List[dict], channels: List[str],
                            years: List[int], out_dir: str | Path
                            ) -> List[Path]:
    """Per-channel obs/pred timeseries + anomaly sheets + the masked
    ysfc_min map (the reference main's output inventory :566-712)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for ch in channels:
        safe = ch.replace(".", "_")
        for anomaly, suffix in ((False, ""), (True, "_anomaly")):
            p = _diag_sheet(records, ch, years,
                            out_dir / f"forest_diag_{safe}{suffix}.png",
                            anomaly=anomaly)
            paths += [p] if p is not None else []
    n_dist = [int((rec["aoi_forest_mask"] & np.isfinite(rec["ysfc_min"])
                   & (rec["ysfc_min"] < 10)).sum()) for rec in records]
    p = out_dir / "forest_diag_ysfc_min.png"
    plt = pyplot(p.name)
    if plt is None:
        return paths
    n = len(records)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.5), squeeze=False)
    im = None
    for i, rec in enumerate(records):
        ax = axes[0, i]
        im = ax.imshow(_masked(rec["ysfc_min"], rec["combined_mask"]),
                       cmap="RdYlGn", vmin=0, vmax=40,
                       interpolation="nearest")
        ax.set_title(f"Patch {rec['patch_idx']} (ysfc<10: {n_dist[i]})",
                     fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.suptitle("ysfc_min (years since fast change)", fontsize=11)
    fig.tight_layout(rect=(0, 0, 0.92, 0.96))
    if im is not None:
        fig.colorbar(im, cax=fig.add_axes((0.93, 0.08, 0.015, 0.84)),
                     label="years")
    fig.savefig(p, dpi=130, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)
    return paths


def make_encode_gate(model, fb, type_feature: str = "type_encoder_input"
                     ) -> Callable:
    """encode_gate(batch) -> (z_type [B, H, W, zt], the smoothing gate
    [B, H, W, zt]): the type forward with ``return_gate``."""

    @torch.inference_mode()
    def encode_gate(batch):
        x, _ = fb.build_feature(type_feature, batch)
        return model(x, return_gate=True)

    return encode_gate


def main(argv=None):
    """CLI: figure sheets from a trained checkpoint.

    python -m forest_tpu_torch.eval.visualize --checkpoint CKPT
        --bindings B.yaml --out DIR [--split test] [--patch-size 256]
        [--n 4] [--probe] [--forest-diag] [--device cuda]
    """
    import argparse

    from forest_tpu_torch.data.bindings import parse_bindings
    from forest_tpu_torch.data.feature_builder import FeatureBuilder
    from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
    from forest_tpu_torch.eval import frozen, linear_probe as lp

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--patch-size", type=int, default=256)
    ap.add_argument("--split-block-size", type=int, nargs=2,
                    default=(4, 4))
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--target-feature", default="infonce_type_spectral")
    ap.add_argument("--probe", action="store_true",
                    help="also fit + overlay a linear probe")
    ap.add_argument("--forest-diag", action="store_true",
                    help="emit the reference forest-diagnostics family: "
                         "ysfc-ranked patches, obs-vs-PREDICTED temporal "
                         "sheets via a phase probe, anomaly sheets, "
                         "masked ysfc_min maps")
    ap.add_argument("--ysfc-source", default="annual.ysfc")
    ap.add_argument("--device", default="cuda",
                    help="where the encoder and the probes run "
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

    weights = None
    if a.probe:
        ds_tr = ForestDatasetV2(bindings, split="train",
                                patch_size=a.patch_size,
                                split_block_size=tuple(a.split_block_size))
        probe = lp.fit_linear_probe(enc_t, fb, ds_tr, ds,
                                    a.target_feature,
                                    max_batches_train=16,
                                    max_batches_eval=4, device=device)
        weights = probe["weights"]
        print("probe r2 (val):", probe["r2_val"])

    paths = visualize_test_patches(enc_t, fb, ds, a.target_feature,
                                   weights, a.out, a.n, device=device)
    encode_gate = make_encode_gate(model, fb)
    paths += visualize_forest_diagnostics(encode_gate, ds, a.out, a.n,
                                          device=device)
    # reference-depth sheets: per-variable obs/pred grids (original scale),
    # top-variance gate channels, ysfc maps
    fc = fb.bindings.get_feature(a.target_feature)
    records = collect_patch_records(enc_t, fb, ds, a.target_feature,
                                    weights, a.n, device=device)
    paths += plot_variable_sheets(records, list(fc.channels.keys()), a.out)
    paths += plot_gate_channel_sheets(encode_gate, ds, a.out, a.n,
                                      device=device)
    try:
        paths += plot_ysfc_map(ds, a.ysfc_source, a.out, a.n)
    except (KeyError, ValueError):
        pass  # cube without a ysfc channel

    if a.forest_diag:
        from forest_tpu_torch.eval import phase_probe as pp

        phase_feature = getattr(model, "phase_feature", "phase_ccdc")
        ph = (bindings.losses or {}).get("phase_neighborhood") or {}
        nt = ph.get("neighborhood_target")
        tfeat = nt.split(".", 1)[1] if isinstance(nt, str) \
            and nt.startswith("features.") else (nt or phase_feature)
        if tfeat not in bindings.features:
            tfeat = phase_feature
        targets_fn = make_phase_target_fn(fb, tfeat)

        def enc_phase_fn(batch, coords):
            zp = enc_p(batch, coords)
            ta, tm = targets_fn(batch, coords)
            return zp, ta, tm

        w, pre = pp.fit_phase_probe(enc_t, enc_phase_fn, ds,
                                    max_batches=8, device=device)
        ranked = rank_patches_by_ysfc(ds, a.ysfc_source)
        picks = [i for i, _ in ranked[:min(a.n, 3)]]
        records = collect_forest_diag_records(
            enc_t, enc_p, fb, ds, picks, w, pre, tfeat, a.ysfc_source,
            device=device)
        tw = getattr(bindings, "time_window", None)
        years = list(range(tw.start, tw.end + 1)) if tw \
            else list(range(records[0]["T"]))
        chans = list(fb.bindings.get_feature(tfeat).channels.keys())
        paths += plot_forest_diag_sheets(records, chans[:3], years,
                                         a.out)
    print(f"wrote {len(paths)} figures to {a.out}")


if __name__ == "__main__":
    main()


__all__ = ["visualize_test_patches", "visualize_forest_diagnostics",
           "collect_patch_records", "plot_variable_sheets",
           "plot_gate_channel_sheets", "plot_variable_timeseries",
           "plot_variable_anomaly", "plot_ysfc_map",
           "rank_patches_by_ysfc", "collect_forest_diag_records",
           "plot_forest_diag_sheets", "make_encode_gate", "_pca_rgb",
           "main"]
