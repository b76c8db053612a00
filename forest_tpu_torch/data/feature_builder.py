"""FeatureBuilder on tensors: masks, transforms, normalisation, whitening.

Port of ``forest_tpu/data/feature_builder.py`` (``build_feature`` and
``build_feature_at_locations``), same order of operations and channel-last
layout:

- the channels of a feature are read from named dataset groups
  ("group.channel"), each with its validity = finite AND its mask channel
  (> 0, a spatial mask broadcast over T for temporal features);
- the pre-transform, then zeroing of invalid entries and the normalisation
  preset (zscore / robust_iqr / linear_rescale / clamp / identity) with the
  stats of the JSON sidecar;
- Mahalanobis whitening when the feature asks for covariance.

The builder turns a feature's bindings and stats into a plan once, and the
plan into a parameter table once per device (whitening matrix and mean
included), kept there. A build is then one call of the op
``forest_tpu_torch::feature_build`` (``ops/feature_build.py``): one kernel
launch on a card, the plain version on the CPU, no copy from the host.
A feature with a transform added by ``data.transforms.register`` is built
by the same PyTorch operations one channel at a time (``feature_build.
compose``) on every device; ``feature_build.builds`` counts the builds of
each path.

``group_data`` values are tensors (or arrays, taken to the CPU) with any
leading batch dims; the output lies on the device of the input. Each build
runs in the span ``data.features`` (``utils.spans``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.bindings import (BindingsConfig,
                                            NormalizationPresetConfig)
from forest_tpu_torch.ops import feature_build as fbk
from forest_tpu_torch.ops.whitening import whitening_matrix
from forest_tpu_torch.utils.spans import span


# the JAX FeatureBuilder's defaults, which every caller uses
WHITEN_CLIP = 5.0
WHITEN_EPS = 1e-6


class _Plan(NamedTuple):
    groups: Tuple[str, ...]                 # slot -> dataset group
    channels: Tuple[fbk.Channel, ...]
    temporal: bool
    whitening: Optional[Tuple[np.ndarray, np.ndarray]]   # (W, mean)
    kernel: bool          # the op builds it: every transform is built in


def norm_of(preset: NormalizationPresetConfig, st: Dict[str, float]
            ) -> fbk.Norm:
    """A preset and a channel's stats as the float32 values the build
    applies."""
    t = preset.type
    flags, off, scale, mul, add = 0, 0.0, 1.0, 1.0, 0.0
    if t == "zscore":
        sd = st.get("sd", 1.0)
        flags, off, scale = fbk.AFFINE, st.get("mean", 0.0), \
            sd if sd and sd > 1e-8 else 1.0
    elif t == "robust_iqr":
        iqr = st.get("q75", 1.0) - st.get("q25", 0.0)
        flags, off, scale = fbk.AFFINE, st.get("q50", 0.0), \
            iqr if iqr > 1e-8 else 1.0
    elif t == "linear_rescale":
        in_min = preset.in_min if preset.in_min is not None \
            else st.get("min", 0.0)
        in_max = preset.in_max if preset.in_max is not None \
            else st.get("max", 1.0)
        rng = in_max - in_min
        out_min = preset.out_min if preset.out_min is not None else 0.0
        out_max = preset.out_max if preset.out_max is not None else 1.0
        flags = fbk.AFFINE | fbk.RESCALE
        off, scale = in_min, rng if rng > 1e-8 else 1.0
        mul, add = out_max - out_min, out_min
    elif t not in ("clamp", "none", "identity"):
        raise ValueError(f"unknown normalization type {t!r}")
    lo = hi = None
    if preset.clamp and preset.clamp.get("enabled", False):
        lo, hi = preset.clamp.get("min"), preset.clamp.get("max")
        if lo is None and hi is None:
            raise ValueError(f"preset {preset.name!r}: a clamp needs a min "
                             f"or a max")
        flags |= (fbk.LO if lo is not None else 0) | \
            (fbk.HI if hi is not None else 0)
    return fbk.Norm(flags, *(fbk.f32(v) for v in (
        off, scale, mul, add, lo or 0.0, hi or 0.0)))


class FeatureBuilder:
    def __init__(self, bindings: BindingsConfig,
                 stats: Optional[Dict] = None):
        self.bindings = bindings
        if stats is None and bindings.stats.file and \
                Path(bindings.stats.file).exists():
            stats = json.loads(Path(bindings.stats.file).read_text())
        self.stats = stats or {}
        self._plans: Dict[str, _Plan] = {}
        self._tables: Dict[Tuple[str, torch.device], Tuple] = {}

    def channel_stats(self, feature_name: str, channel_ref: str
                      ) -> Dict[str, float]:
        return self.stats.get(feature_name, {}).get(channel_ref, {}) or \
            self.stats.get("channels", {}).get(channel_ref, {})

    def _whitening_for(self, feature_name: str
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self.bindings.get_feature(feature_name).covariance.calculate:
            return None
        cov_entry = self.stats.get(feature_name, {}).get("__covariance__")
        if cov_entry is None:
            return None
        cov = np.asarray(cov_entry["matrix"], np.float64)
        mean = np.asarray(cov_entry.get("mean", np.zeros(cov.shape[0])),
                          np.float32)
        return whitening_matrix(cov, WHITEN_EPS), mean

    def _plan(self, feature_name: str) -> _Plan:
        plan = self._plans.get(feature_name)
        if plan is not None:
            return plan
        fc = self.bindings.get_feature(feature_name)
        slots: Dict[str, int] = {}

        def slot(ref: str) -> Tuple[int, int]:
            gname, cname = ref.split(".")
            ci = self.bindings.dataset[gname].channel_index(cname)
            return slots.setdefault(gname, len(slots)), ci

        chans = tuple(fbk.Channel(
            slot(ref), slot(spec.mask) if spec.mask else None,
            spec.transform or None,
            norm_of(self.bindings.get_normalization_preset(spec.norm),
                    self.channel_stats(feature_name, ref)))
            for ref, spec in fc.channels.items())
        plan = _Plan(tuple(slots), chans, fc.temporal,
                     self._whitening_for(feature_name),
                     all(fbk.kernel_takes(ch.transform) for ch in chans))
        self._plans[feature_name] = plan
        return plan

    def _table(self, feature_name: str, plan: _Plan, device: torch.device):
        """-> (itab, ftab, W, mean) on ``device``, made once (the tables
        None where the op does not build the feature, W and mean None where
        it is not whitened)."""
        key = (feature_name, device)
        tab = self._tables.get(key)
        if tab is None:
            host = (fbk.table(plan.channels) if plan.kernel
                    else (None, None)) + (plan.whitening or (None, None))
            with torch.inference_mode(False):
                tab = tuple(None if a is None else torch.from_numpy(
                    np.ascontiguousarray(a)).to(device) for a in host)
            self._tables[key] = tab
        return tab

    def _build(self, feature_name: str, group_data: Dict[str, torch.Tensor],
               coords: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        plan = self._plan(feature_name)
        groups = [torch.as_tensor(group_data[g]) for g in plan.groups]
        dev = groups[0].device
        itab, ftab, w, mu = self._table(feature_name, plan, dev)
        if plan.kernel:
            fbk.feature_build.builds["kernel"] += 1
            return fbk.feature_build(groups, itab, ftab, w, mu, coords,
                                     plan.temporal, WHITEN_CLIP)
        fbk.feature_build.builds["composed"] += 1
        return fbk.compose(groups, plan.channels, w, mu, plan.temporal,
                           WHITEN_CLIP, coords)

    def build_feature(self, feature_name: str,
                      group_data: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (x [.., H, W, C] or [.., T, H, W, C], bool mask of x's shape)."""
        with span("data.features"):
            return self._build(feature_name, group_data, None)

    def build_feature_at_locations(self, feature_name: str,
                                   group_data: Dict[str, torch.Tensor],
                                   coords: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Build a feature only at sampled pixels, each channel read there.

        Batched over B: ``group_data`` values are [B, H, W, C] or
        [B, T, H, W, C] (keys starting with ``__`` are skipped), ``coords``
        [B, N, 2] (row, col). Returns ([B, N, C], mask) or, for a temporal
        feature, ([B, N, T, C], mask): what indexing the full-grid build at
        ``coords`` gives. A negative coordinate counts from the end, as a
        tensor index does; a pixel outside the grid gives an invalid row (x
        0, mask False), on every device."""
        with span("data.features"):
            return self._build(feature_name, group_data, coords)


__all__ = ["FeatureBuilder"]
