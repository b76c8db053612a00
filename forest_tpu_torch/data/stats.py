"""StatsCalculator: per-channel stats + per-feature covariance -> JSON sidecar.

Port of ``forest_tpu/data/stats.py`` (``OnlineCovarianceComputer``,
``StatsCalculator``, ``compute_stats_from_config``), the same draws from the
same seed:

- sample N patches (bindings ``stats.samples.n``) and keep a per-channel
  reservoir over the valid masked pixels (numpy, on the host);
- univariate stats [mean, sd, min, max, q02..q98] per channel, in the domain
  of the channel's pre-transform, and value counts for integer channels;
- per-feature covariance of the NORMALISED channels (whitening consumes
  it), patch-centred (each patch's own channel means subtracted before
  accumulating) or global-centred: the features are built by the port's
  :class:`FeatureBuilder` on ``device`` (the card unless the caller asks
  for the CPU) and accumulated in float64 on the host;
- written as the JSON that :class:`FeatureBuilder` reads.

``OnlineCovarianceComputer`` is the Welford / Chan single-pass merge.
The derived-feature statistics of the JAX module (``DerivedStatsComputer``,
``load_derived_stats``, ``derived_normalizer``) are not ported: no training
path calls them.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from forest_tpu_torch.data.bindings import BindingsConfig
from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.data.samplers import ReservoirSampler
from forest_tpu_torch.data.transforms import apply_transform


class OnlineCovarianceComputer:
    """NaN-safe streaming mean/covariance (Chan parallel merge)."""

    def __init__(self, dim: int):
        self.n = 0.0
        self.mean = np.zeros(dim)
        self.m2 = np.zeros((dim, dim))

    def update(self, x: np.ndarray) -> None:
        """x [N, C]; rows with any NaN are dropped."""
        x = np.asarray(x, np.float64)
        x = x[np.isfinite(x).all(axis=1)]
        nb = len(x)
        if nb == 0:
            return
        mb = x.mean(0)
        xc = x - mb
        m2b = xc.T @ xc
        if self.n == 0:
            self.n, self.mean, self.m2 = float(nb), mb, m2b
            return
        delta = mb - self.mean
        tot = self.n + nb
        self.m2 = self.m2 + m2b + np.outer(delta, delta) * self.n * nb / tot
        self.mean = self.mean + delta * nb / tot
        self.n = tot

    def covariance(self, regularize: float = 0.0) -> np.ndarray:
        if self.n < 2:
            return np.eye(len(self.mean))
        c = self.m2 / (self.n - 1)
        if regularize:
            c = c + regularize * np.eye(len(self.mean))
        return c


_QS = {"q02": 2, "q05": 5, "q25": 25, "q50": 50, "q75": 75, "q95": 95,
       "q98": 98}


class StatsCalculator:
    def __init__(self, bindings: BindingsConfig, dataset, seed: int = 0,
                 device="cuda"):
        self.bindings = bindings
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def _global_mask(self, patch: Dict[str, np.ndarray]) -> np.ndarray:
        """Product of the bindings stats.mask references -> [H, W]."""
        m = None
        for ref in self.bindings.stats.mask:
            gname, cname = ref.split(".")
            g = self.bindings.dataset[gname]
            x = patch[gname][..., g.channel_index(cname)]
            mm = np.nan_to_num(np.asarray(x, np.float32)) > 0
            m = mm if m is None else (m & mm)
        if m is None:
            any_g = next(k for k in patch if not k.startswith("__"))
            shape = patch[any_g].shape
            hw = shape[-3:-1] if len(shape) >= 3 else shape[:2]
            m = np.ones(hw, bool)
        return m

    def compute(self, n_patches: Optional[int] = None) -> Dict:
        cfg = self.bindings.stats
        n_patches = n_patches or cfg.n_samples
        n_avail = len(self.dataset)
        picks = self.rng.choice(n_avail, min(n_patches, n_avail),
                                replace=False)
        patches = [self.dataset.get_patch(int(i)) for i in picks]

        stats: Dict[str, Dict] = {}
        # --- univariate per (feature, channel) over reservoirs ----------
        for fname, fc in self.bindings.features.items():
            stats[fname] = {}
            for ref, spec in fc.channels.items():
                res = ReservoirSampler(cfg.reservoir_size,
                                       seed=int(self.rng.integers(2**31)))
                counts: Dict[int, int] = {}
                gname, cname = ref.split(".")
                gcfg = self.bindings.dataset[gname]
                is_cat = gcfg.dtype.startswith("int")
                for patch in patches:
                    x = np.asarray(
                        patch[gname][..., gcfg.channel_index(cname)],
                        np.float32)
                    gm = self._global_mask(patch)
                    if x.ndim == gm.ndim + 1:   # temporal
                        gm = np.broadcast_to(gm[None], x.shape)
                    vals = x[gm & np.isfinite(x)]
                    # in the domain FeatureBuilder normalises in: after the
                    # channel's pre-transform
                    if spec.transform:
                        vals = apply_transform(
                            spec.transform, torch.from_numpy(vals)).numpy()
                        vals = vals[np.isfinite(vals)]
                    if is_cat:
                        u, c = np.unique(vals.astype(np.int64),
                                         return_counts=True)
                        for uu, cc in zip(u, c):
                            counts[int(uu)] = counts.get(int(uu), 0) \
                                + int(cc)
                    if vals.size:
                        res.add(vals[:, None])
                buf = res.sample().ravel() if res.n_seen else \
                    np.zeros(1, np.float32)
                entry: Dict = {}
                for s in cfg.stats:
                    if s == "mean":
                        entry["mean"] = float(buf.mean())
                    elif s == "sd":
                        entry["sd"] = float(buf.std())
                    elif s == "min":
                        entry["min"] = float(buf.min())
                    elif s == "max":
                        entry["max"] = float(buf.max())
                    elif s in _QS:
                        entry[s] = float(np.percentile(buf, _QS[s]))
                entry["n_seen"] = int(res.n_seen)
                if is_cat:
                    entry["counts"] = {str(k): v
                                       for k, v in sorted(counts.items())}
                stats[fname][ref] = entry

        # --- covariance of the normalised channels ----------------------
        if cfg.covariance:
            fb = FeatureBuilder(self.bindings, stats)
            for fname, fc in self.bindings.features.items():
                if not fc.covariance.calculate:
                    continue
                dim = len(fc.channels)
                occ = OnlineCovarianceComputer(dim)
                patch_centered = fc.covariance.stat_domain == "patch"
                for patch in patches:
                    groups = {k: torch.from_numpy(np.asarray(v)).to(
                        self.device) for k, v in patch.items()
                        if not k.startswith("__")}
                    x, mask = fb.build_feature(fname, groups)
                    rows = x.cpu().numpy().astype(np.float64) \
                        .reshape(-1, dim)
                    ok = mask.cpu().numpy().reshape(-1, dim).all(axis=1)
                    rows = rows[ok]
                    if len(rows) < 2:
                        continue
                    if patch_centered:
                        rows = rows - rows.mean(0)
                    occ.update(rows)
                stats[fname]["__covariance__"] = {
                    "matrix": occ.covariance(1e-8).tolist(),
                    "mean": (np.zeros(dim) if patch_centered
                             else occ.mean).tolist(),
                    "n": occ.n,
                    "stat_domain": fc.covariance.stat_domain,
                }
        return stats

    def compute_and_save(self, n_patches: Optional[int] = None) -> Path:
        stats = self.compute(n_patches)
        out = Path(self.bindings.stats.file)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(stats, indent=1))
        return out


def compute_stats_from_config(bindings: BindingsConfig, dataset=None,
                              device="cuda", **kw) -> Path:
    """The compute-stats pipeline step: every patch of the cube
    (``ForestDatasetV2`` with ``split=None`` and ``kw``) unless a dataset
    is given."""
    if dataset is None:
        from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
        dataset = ForestDatasetV2(bindings, split=None, **kw)
    return StatsCalculator(bindings, dataset,
                           device=device).compute_and_save()


__all__ = ["StatsCalculator", "OnlineCovarianceComputer",
           "compute_stats_from_config"]
