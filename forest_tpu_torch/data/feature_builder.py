"""FeatureBuilder on tensors: masks, transforms, normalisation, whitening.

Port of ``forest_tpu/data/feature_builder.py`` (``build_feature``), same
order of operations and channel-last layout:

- the channels of a feature are read from named dataset groups
  ("group.channel"), each with its validity = finite AND its mask channel
  (> 0, a spatial mask broadcast over T for temporal features);
- the pre-transform, then zeroing of invalid entries and the normalisation
  preset (zscore / robust_iqr / linear_rescale / clamp / identity) with the
  stats of the JSON sidecar;
- Mahalanobis whitening when the feature asks for covariance.

``group_data`` values are tensors (or arrays, taken to the CPU) with any
leading batch dims; the output lies on the device of the input.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from forest_tpu.data.bindings import (BindingsConfig, FeatureConfig,
                                      NormalizationPresetConfig)
from forest_tpu_torch.data.transforms import apply_transform
from forest_tpu_torch.ops.whitening import apply_whitening, whitening_matrix


# the JAX FeatureBuilder's defaults, which every caller uses
WHITEN_CLIP = 5.0
WHITEN_EPS = 1e-6


class FeatureBuilder:
    def __init__(self, bindings: BindingsConfig,
                 stats: Optional[Dict] = None):
        self.bindings = bindings
        if stats is None and bindings.stats.file and \
                Path(bindings.stats.file).exists():
            stats = json.loads(Path(bindings.stats.file).read_text())
        self.stats = stats or {}
        self._w_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def _group_channel(self, group_data: Dict[str, torch.Tensor],
                       ref: str) -> torch.Tensor:
        gname, cname = ref.split(".")
        ci = self.bindings.dataset[gname].channel_index(cname)
        return torch.as_tensor(group_data[gname])[..., ci].float()

    def channel_stats(self, feature_name: str, channel_ref: str
                      ) -> Dict[str, float]:
        return self.stats.get(feature_name, {}).get(channel_ref, {}) or \
            self.stats.get("channels", {}).get(channel_ref, {})

    def _normalize(self, x: torch.Tensor, preset: NormalizationPresetConfig,
                   st: Dict[str, float]) -> torch.Tensor:
        t = preset.type
        if t == "zscore":
            sd = st.get("sd", 1.0)
            sd = sd if sd and sd > 1e-8 else 1.0
            x = (x - st.get("mean", 0.0)) / sd
        elif t == "robust_iqr":
            iqr = st.get("q75", 1.0) - st.get("q25", 0.0)
            iqr = iqr if iqr > 1e-8 else 1.0
            x = (x - st.get("q50", 0.0)) / iqr
        elif t == "linear_rescale":
            in_min = preset.in_min if preset.in_min is not None \
                else st.get("min", 0.0)
            in_max = preset.in_max if preset.in_max is not None \
                else st.get("max", 1.0)
            rng = in_max - in_min
            rng = rng if rng > 1e-8 else 1.0
            out_min = preset.out_min if preset.out_min is not None else 0.0
            out_max = preset.out_max if preset.out_max is not None else 1.0
            x = (x - in_min) / rng * (out_max - out_min) + out_min
        elif t not in ("clamp", "none", "identity"):
            raise ValueError(f"unknown normalization type {t!r}")
        if preset.clamp and preset.clamp.get("enabled", False):
            x = torch.clamp(x, preset.clamp.get("min"),
                            preset.clamp.get("max"))
        return x

    def _whitening_for(self, feature_name: str, fc: FeatureConfig
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not fc.covariance.calculate:
            return None
        if feature_name in self._w_cache:
            return self._w_cache[feature_name]
        cov_entry = self.stats.get(feature_name, {}).get("__covariance__")
        if cov_entry is None:
            return None
        cov = np.asarray(cov_entry["matrix"], np.float64)
        mean = np.asarray(cov_entry.get("mean", np.zeros(cov.shape[0])),
                          np.float32)
        w = whitening_matrix(cov, WHITEN_EPS)
        self._w_cache[feature_name] = (w, mean)
        return w, mean

    def build_feature(self, feature_name: str,
                      group_data: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (x [.., H, W, C] or [.., T, H, W, C], bool mask of x's shape)."""
        fc = self.bindings.get_feature(feature_name)
        chans, masks = [], []
        for ref, spec in fc.channels.items():
            x = self._group_channel(group_data, ref)
            valid = torch.isfinite(x)
            if spec.mask:
                m = self._group_channel(group_data, spec.mask)
                # spatial -> temporal broadcast when needed
                if fc.temporal and m.dim() == x.dim() - 1:
                    m = m.unsqueeze(-3).expand(x.shape)
                elif fc.temporal and m.dim() == x.dim() and \
                        m.shape != x.shape:
                    m = m.expand(x.shape)
                valid = valid & (m > 0)
            if spec.transform:
                x = apply_transform(spec.transform, x)
                valid = valid & torch.isfinite(x)
            preset = self.bindings.get_normalization_preset(spec.norm)
            st = self.channel_stats(feature_name, ref)
            zero = torch.zeros_like(x)
            x = self._normalize(torch.where(valid, x, zero), preset, st)
            chans.append(torch.where(valid, x, zero))
            masks.append(valid)
        x = torch.stack(chans, dim=-1)
        mask = torch.stack(masks, dim=-1)

        wm = self._whitening_for(feature_name, fc)
        if wm is not None:
            w, mean = wm
            x = apply_whitening(x, torch.as_tensor(w, device=x.device),
                                torch.as_tensor(mean, device=x.device),
                                mask, clip=WHITEN_CLIP)
        return x, mask


__all__ = ["FeatureBuilder"]
