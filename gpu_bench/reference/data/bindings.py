# Frozen copy of forest_tpu_torch/data/bindings.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Bindings configuration: typed dataclasses + YAML parser.

Behavioral contracts from original:frl/data/loaders/config/
dataset_config.py:13-523 and dataset_bindings_parser.py:47-677 (SURVEY.md
§2.3): the bindings YAML names the zarr cube, the time window, the stats
sidecar, raw dataset groups (channels with source paths, year selection,
ok_if thresholding, fill values, reducers, formula channels), model features
(ordered channel specs with mask/quality references, pre-transforms and
normalization presets, optional covariance/whitening), sampling strategies,
and loss configs. ``${ENV}`` interpolation is supported in paths.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml


def _expand_env(s: str) -> str:
    return re.sub(r"\$\{(\w+)\}",
                  lambda m: os.environ.get(m.group(1), m.group(0)), s)


@dataclass
class OkIf:
    op: str = ">="
    value: float = 1.0

    def apply(self, x):
        import numpy as np
        ops = {">=": np.greater_equal, ">": np.greater,
               "<=": np.less_equal, "<": np.less, "==": np.equal,
               "!=": np.not_equal}
        return ops[self.op](x, self.value).astype(np.float32)


@dataclass
class ChannelConfig:
    name: str
    source: Optional[str] = None       # zarr path under the cube root
    formula: Optional[str] = None      # e.g. 'temporal_position'
    year: Optional[int] = None         # extract one year from annual source
    ok_if: Optional[OkIf] = None
    fill_value: Optional[float] = None  # raw value meaning "missing" -> NaN
    reducer: Optional[str] = None      # mean|max|min|sum over T


@dataclass
class DatasetGroupConfig:
    name: str
    dtype: str = "float32"
    dim: Sequence[str] = ("C", "H", "W")   # [C,H,W] or [C,T,H,W]
    channels: List[ChannelConfig] = field(default_factory=list)

    @property
    def temporal(self) -> bool:
        return "T" in self.dim

    def channel_index(self, name: str) -> int:
        for i, c in enumerate(self.channels):
            if c.name == name:
                return i
        raise KeyError(f"{self.name}: no channel {name!r}")


@dataclass
class NormalizationPresetConfig:
    name: str
    type: str = "identity"       # zscore|robust_iqr|linear_rescale|clamp|none
    in_min: Optional[float] = None
    in_max: Optional[float] = None
    out_min: Optional[float] = None
    out_max: Optional[float] = None
    clamp: Optional[Dict[str, Any]] = None


@dataclass
class FeatureChannelSpec:
    source: str                       # "group.channel"
    mask: Optional[str] = None        # "group.channel" validity mask
    quality: Optional[str] = None
    norm: str = "identity"
    # pre-normalization transform: a name or a parameterized dict
    # ({name: log, epsilon: ...} -- frl_binding_v1.yaml:310)
    transform: Optional[Any] = None


@dataclass
class CovarianceConfig:
    calculate: bool = False
    stat_domain: str = "patch"        # 'patch' | 'global'


@dataclass
class FeatureConfig:
    name: str
    dim: Sequence[str] = ("C", "H", "W")
    channels: Dict[str, FeatureChannelSpec] = field(default_factory=dict)
    covariance: CovarianceConfig = field(default_factory=CovarianceConfig)

    @property
    def temporal(self) -> bool:
        return "T" in self.dim

    @property
    def channel_names(self) -> List[str]:
        return list(self.channels.keys())


@dataclass
class StatsConfig:
    compute: str = "if-not-exists"
    file: str = ""
    stats: Sequence[str] = ("mean", "sd", "min", "max", "q02", "q05", "q25",
                            "q50", "q75", "q95", "q98")
    covariance: bool = True
    n_samples: int = 500
    reservoir_size: int = 500_000
    mask: Sequence[str] = ()


@dataclass
class TimeWindowConfig:
    start: int = 0
    end: int = 0

    @property
    def num_years(self) -> int:
        return self.end - self.start + 1


@dataclass
class BindingsConfig:
    version: str = "1.0"
    name: str = ""
    zarr_path: str = ""
    structure: str = "hierarchical"
    time_window: TimeWindowConfig = field(default_factory=TimeWindowConfig)
    stats: StatsConfig = field(default_factory=StatsConfig)
    dataset: Dict[str, DatasetGroupConfig] = field(default_factory=dict)
    features: Dict[str, FeatureConfig] = field(default_factory=dict)
    normalization_presets: Dict[str, NormalizationPresetConfig] = \
        field(default_factory=dict)
    sampling_strategies: Dict[str, Dict] = field(default_factory=dict)
    losses: Dict[str, Dict] = field(default_factory=dict)

    def get_feature(self, name: str) -> FeatureConfig:
        try:
            return self.features[name]
        except KeyError:
            raise KeyError(
                f"feature {name!r} not defined in bindings; available: "
                f"{sorted(self.features)}") from None

    def groups_for_features(self, feature_names) -> set:
        """Dataset groups a set of features reads (channels + their masks).

        Inference paths that only run some features can drop the other
        groups before device transfer -- the full group dict is ~10x the
        bytes the type encoder needs (export_embeddings measured 87 ->
        ~7 MB/batch over the slow relay H2D link)."""
        need = set()
        for fn in feature_names:
            fc = self.get_feature(fn)
            for ref, spec in fc.channels.items():
                need.add(ref.split(".")[0])
                if spec.mask:
                    need.add(spec.mask.split(".")[0])
        return need

    def get_loss(self, name: str) -> Dict:
        return self.losses[name]

    def get_sampling_strategy(self, name: str) -> Dict:
        return self.sampling_strategies[name]

    def get_normalization_preset(self, name: str
                                 ) -> NormalizationPresetConfig:
        if name in self.normalization_presets:
            return self.normalization_presets[name]
        # Bare type names act as implicit presets (zscore, robust_iqr, ...).
        return NormalizationPresetConfig(name=name, type=name)


def _parse_channel(spec: Any) -> ChannelConfig:
    if isinstance(spec, str):
        return ChannelConfig(name=spec.split("/")[-1], source=spec)
    d = dict(spec)
    ok_if = d.get("ok_if")
    year = d.get("year")
    t = d.get("time")
    if isinstance(t, dict) and "use" in t:
        year = t["use"]
    return ChannelConfig(
        name=d["name"], source=d.get("source"), formula=d.get("formula"),
        year=year,
        ok_if=OkIf(**ok_if) if ok_if else None,
        fill_value=d.get("fill_value"), reducer=d.get("reducer"))


def _parse_feature_channels(spec: Any) -> Dict[str, FeatureChannelSpec]:
    out: Dict[str, FeatureChannelSpec] = {}
    if isinstance(spec, dict):
        items = spec.items()
    else:  # list of single-key dicts or strings
        items = []
        for entry in spec:
            if isinstance(entry, str):
                items.append((entry, {}))
            else:
                (k, v), = entry.items()
                items.append((k, v))
    for src, opts in items:
        opts = opts or {}
        if isinstance(opts, str):
            opts = {"norm": opts}
        out[src] = FeatureChannelSpec(
            source=src, mask=opts.get("mask"),
            quality=None if opts.get("quality") in (None, "none")
            else opts.get("quality"),
            norm=opts.get("norm", "identity"),
            transform=opts.get("transform"))
    return out


def _feat(ref):
    """'features.x' channel references -> bare feature name 'x'."""
    if isinstance(ref, str) and ref.startswith("features."):
        return ref.split(".", 1)[1]
    return ref


def normalize_reference_losses(losses: Dict[str, Dict]) -> Dict[str, Dict]:
    """Map the reference bindings' NESTED loss schema onto this repo's
    flattened keys, applied ONCE at parse time so every consumer of
    ``BindingsConfig.losses`` sees one schema.

    The reference nests pair parameters under strategy blocks and names
    two losses differently
    (original:frl/config/frl_binding_v1.yaml:240-520): knn/negative
    params under positive_strategy.selection / negative_strategy.selection,
    phase params under pair_strategy / pair_weights,
    ``soft_neighborhood_phase`` for this repo's ``phase_neighborhood``,
    ``soft_neighborhood_evt`` for ``evt_soft_neighborhood``, and
    ``confusion_matrix_path`` for ``confusion_csv``. Repo-style entries
    pass through untouched; the reference form is detected by its nested
    blocks, and flattened keys already present always win (setdefault)."""
    out = dict(losses or {})

    def lift(name, entry, pairs):
        e = dict(entry)
        for k, v in pairs:
            if v is not None:
                e.setdefault(k, v)
        out[name] = e

    sp = out.get("infonce_type_spatial")
    if isinstance(sp, dict) and "positive_strategy" in sp:
        pos = (sp.get("positive_strategy") or {}).get("selection") or {}
        neg = (sp.get("negative_strategy") or {}).get("selection") or {}
        wgt = sp.get("spectral_weighting") or {}
        lift("infonce_type_spatial", sp, (
            ("knn_k", pos.get("k")),
            ("knn_max_radius", pos.get("max_distance")),
            ("neg_min_distance", neg.get("min_distance")),
            ("neg_max_distance", neg.get("max_distance")),
            ("neg_per_anchor", neg.get("n_per_anchor")),
            ("spectral_sigma", wgt.get("tau")),
            ("min_pair_weight", wgt.get("min_weight")),
            ("feature", _feat(wgt.get("feature")))))
    spec = out.get("infonce_type_spectral")
    if isinstance(spec, dict) and "positive_strategy" in spec:
        pos = (spec.get("positive_strategy") or {}).get("selection") or {}
        lift("infonce_type_spectral", spec, (
            ("knn_k", pos.get("k")),
            ("pos_min_spatial", pos.get("min_distance")),
            ("chunk_size", spec.get("spectral_knn_chunk_size"))))
    ph = out.get("soft_neighborhood_phase")
    if isinstance(ph, dict) and "phase_neighborhood" not in out:
        pstrat = ph.get("pair_strategy") or {}
        ov = pstrat.get("ysfc_overlap") or {}
        pw = ph.get("pair_weights") or {}
        lift("phase_neighborhood", ph, (
            ("k", (pstrat.get("type_similarity") or {}).get("k")),
            ("min_overlap", ov.get("min_overlap")),
            ("ysfc_source", ov.get("channel")),
            ("min_pairs", pstrat.get("min_pairs")),
            ("sigma", pw.get("sigma")),
            ("self_weight", ph.get("self_similarity_weight")),
            ("cross_weight", ph.get("cross_pixel_weight")),
            ("proj_rank", ph.get("phase_type_proj_rank")),
            ("proj_neighbors", ph.get("phase_type_proj_neighbors"))))
    evt = out.get("soft_neighborhood_evt")
    if isinstance(evt, dict) and "evt_soft_neighborhood" not in out:
        lift("evt_soft_neighborhood", evt, (
            ("confusion_csv", evt.get("confusion_matrix_path")),))
    return out


def parse_bindings(path_or_dict: Any) -> BindingsConfig:
    if isinstance(path_or_dict, (str, Path)):
        raw = yaml.safe_load(_expand_env(Path(path_or_dict).read_text()))
    else:
        raw = path_or_dict

    tw = raw.get("time_window", {}) or {}
    zarr = raw.get("zarr", {}) or {}
    st = raw.get("stats", {}) or {}
    samples = st.get("samples", {}) or {}

    cfg = BindingsConfig(
        version=str(raw.get("version", "1.0")),
        name=raw.get("name", ""),
        zarr_path=_expand_env(str(zarr.get("path", ""))),
        structure=zarr.get("structure", "hierarchical"),
        time_window=TimeWindowConfig(start=int(tw.get("start", 0)),
                                     end=int(tw.get("end", 0))),
        stats=StatsConfig(
            compute=st.get("compute", "if-not-exists"),
            file=_expand_env(str(st.get("file", ""))),
            stats=tuple(st.get("stats", StatsConfig.stats)),
            covariance=bool(st.get("covariance", True)),
            n_samples=int(samples.get("n", 500)),
            reservoir_size=int(samples.get("reservoir_size", 500_000)),
            mask=tuple(st.get("mask", ()))),
    )

    for gname, gspec in (raw.get("dataset") or {}).items():
        cfg.dataset[gname] = DatasetGroupConfig(
            name=gname, dtype=gspec.get("type", "float32"),
            dim=tuple(gspec.get("dim", ("C", "H", "W"))),
            channels=[_parse_channel(c) for c in gspec.get("channels", [])])

    for fname, fspec in (raw.get("features") or {}).items():
        cov = fspec.get("covariance", {}) or {}
        cfg.features[fname] = FeatureConfig(
            name=fname, dim=tuple(fspec.get("dim", ("C", "H", "W"))),
            channels=_parse_feature_channels(fspec.get("channels", {})),
            covariance=CovarianceConfig(
                calculate=bool(cov.get("calculate", False)),
                stat_domain=cov.get("stat_domain", "patch")))

    for pname, pspec in (raw.get("normalization") or {}).items():
        pspec = pspec or {}
        cfg.normalization_presets[pname] = NormalizationPresetConfig(
            name=pname, type=pspec.get("type", pname),
            in_min=pspec.get("in_min"), in_max=pspec.get("in_max"),
            out_min=pspec.get("out_min"), out_max=pspec.get("out_max"),
            clamp=pspec.get("clamp"))

    cfg.sampling_strategies = dict(raw.get("sampling-strategy")
                                   or raw.get("sampling_strategy") or {})
    cfg.losses = normalize_reference_losses(dict(raw.get("losses") or {}))
    return cfg


__all__ = ["BindingsConfig", "DatasetGroupConfig", "ChannelConfig",
           "FeatureConfig", "FeatureChannelSpec", "CovarianceConfig",
           "NormalizationPresetConfig", "StatsConfig", "TimeWindowConfig",
           "OkIf", "parse_bindings", "normalize_reference_losses"]
