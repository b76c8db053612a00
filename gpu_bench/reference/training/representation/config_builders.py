# Frozen copy of forest_tpu_torch/training/representation/config_builders.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Assemble StepConfig / loss weights / sampler from parsed YAML configs.

Port of ``forest_tpu/training/representation/config_builders.py``
(``build_step_config``, ``build_loss_weights``, ``build_sampler``,
``build_curricula``): every knob is read with an explicit default so partial
configs work; losses declared in the bindings ``losses:`` section override
StepConfig fields.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, Optional

from gpu_bench.reference.data.anchor_sampling import AnchorSampler, build_anchor_sampler
from gpu_bench.reference.data.bindings import (BindingsConfig,
                                      normalize_reference_losses)
from gpu_bench.reference.training.representation.step import (DEFAULT_WEIGHTS,
                                                     StepConfig)


def build_step_config(bindings: BindingsConfig,
                      training_cfg: Dict[str, Any]) -> StepConfig:
    kw: Dict[str, Any] = {}
    # parse_bindings applies bindings.normalize_reference_losses, so the
    # losses dict here is always in this repo's flattened schema; re-apply
    # defensively for hand-built BindingsConfig objects (tests, tools).
    losses = normalize_reference_losses(bindings.losses or {})
    # Accept both this repo's model_input keys and the reference YAML's
    # (model.type_encoder_feature / model.phase_encoder_feature) so
    # reference training configs port without edits. Merged PER KEY
    # (model_input wins) -- parse_training_config performs the same merge,
    # so the CLI path and direct build_step_config calls agree.
    mi = {**(training_cfg.get("model") or {}),
          **(training_cfg.get("model_input") or {})}

    sp = losses.get("infonce_type_spatial", {})
    kw.update(
        spectral_feature=sp.get("feature", "infonce_type_spectral"),
        knn_k=sp.get("knn_k", 4),
        knn_max_radius=sp.get("knn_max_radius", 8),
        neg_min_distance=sp.get("neg_min_distance", 16.0),
        neg_max_distance=sp.get("neg_max_distance"),
        neg_per_anchor=sp.get("neg_per_anchor", 4),
        spectral_sigma=sp.get("spectral_sigma", 2.0),
        min_pair_weight=sp.get("min_pair_weight", 0.05),
        temperature=sp.get("temperature", 0.07),
        similarity=sp.get("similarity", "l2"),
    )
    ph = losses.get("phase_neighborhood", {})
    kw.update(
        phase_feature=ph.get("feature",
                             mi.get("phase_feature",
                                    mi.get("phase_encoder_feature",
                                           "phase_ccdc"))),
        ysfc_source=ph.get("ysfc_source", "annual.ysfc"),
        phase_k=ph.get("k", 16),
        phase_min_overlap=ph.get("min_overlap", 3),
        phase_min_pairs=ph.get("min_pairs", 5),
        phase_sigma=ph.get("sigma", 5.0),
        phase_tau_ref=ph.get("tau_ref", 0.1),
        phase_tau_learned=ph.get("tau_learned", 0.1),
        phase_self_weight=ph.get("self_weight", 1.0),
        phase_cross_weight=ph.get("cross_weight", 1.0),
        xb_phase_pca_dim=ph.get("proj_rank", 8),
        xb_phase_knn_k=ph.get("proj_neighbors", 20),
        num_ysfc_classes=ph.get("num_ysfc_classes", 64),
    )
    spec = losses.get("infonce_type_spectral", {})
    kw.update(
        xb_knn_k=spec.get("knn_k", 10),
        xb_chunk_size=spec.get("chunk_size", 128),
        xb_pos_min_spatial=spec.get("pos_min_spatial", 4.0),
        xb_temperature=spec.get("temperature", 0.07),
        xb_neg_tau=spec.get("spectral_neg_tau", 1.0),
        xb_neg_min_weight=spec.get("spectral_neg_min_weight", 0.05),
    )
    vcr = losses.get("variance_covariance_type", {})
    kw.update(
        vcr_std_target=vcr.get("variance_target", 1.0),
        vcr_variance_weight=vcr.get("variance_weight", 1.0),
        vcr_covariance_weight=vcr.get("covariance_weight", 1.0),
    )
    spread = losses.get("phase_spread_ranking", {})
    kw.update(
        spread_margin=spread.get("margin", 0.1),
        spread_delta=spread.get("delta", 0.5),
        # the spread ranking is supervised with the
        # phase_dynamism_supervision feature when the bindings define it
        dynamism_feature=spread.get(
            "dynamism_feature",
            "phase_dynamism_supervision"
            if "phase_dynamism_supervision" in bindings.features else None),
    )
    rd = losses.get("phase_recovery_discrimination", {})
    kw.update(
        rd_margin=rd.get("margin", 0.5),
        rd_low_ysfc_max=rd.get("low_ysfc_max", 1.0),
        rd_high_ysfc_min=rd.get("high_ysfc_min", 5.0),
    )
    evt = losses.get("evt_soft_neighborhood", {})
    # Enablement respects the effective weight: the reference ships its
    # EVT block with weight 0.0 ("EVT loss disabled"), and enabling it
    # anyway would build the confusion-matrix tables (whose CSV path may
    # not exist for a ported user) and compute a loss multiplied by zero.
    # The training YAML's loss_weights.evt overrides the bindings weight.
    tw = (training_cfg.get("loss_weights") or {}).get("evt")
    evt_w = tw if tw is not None else evt.get("weight", 1.0)
    if evt and float(evt_w) != 0.0:
        kw.update(evt_enabled=True,
                  evt_feature=evt.get("feature", "static_categorical.evt"),
                  evt_tau_ref=evt.get("tau_ref", 0.5),
                  evt_tau_learned=evt.get("tau_learned", 0.5),
                  evt_min_valid_anchors=evt.get("min_valid_anchors", 4))

    step_cfg = training_cfg.get("step", {}) or {}
    valid_fields = {f.name for f in fields(StepConfig)}
    kw.update({k: v for k, v in step_cfg.items() if k in valid_fields})
    kw.setdefault(
        "type_feature",
        mi.get("type_feature",
               mi.get("type_encoder_feature", "type_encoder_input")))
    # Drop unknown keys and None values (None would clobber dataclass
    # defaults) -- except neg_max_distance, where None means "no limit".
    cleaned = {k: v for k, v in kw.items()
               if k in valid_fields
               and (v is not None or k == "neg_max_distance")}
    return StepConfig(**cleaned)


# bindings loss name (reference or repo) -> DEFAULT_WEIGHTS key
_LOSS_WEIGHT_KEY = {
    "infonce_type_spatial": "spatial_infonce",
    "infonce_type_spectral": "spectral_infonce",
    "variance_covariance_type": "vicreg_type",
    "variance_covariance_phase": "vicreg_phase",
    "soft_neighborhood_phase": "phase_neighborhood",
    "phase_neighborhood": "phase_neighborhood",
    "phase_spread_ranking": "phase_spread",
    "phase_recovery_discrimination": "recovery_disc",
    "soft_neighborhood_evt": "evt",
    "evt_soft_neighborhood": "evt",
}


def build_loss_weights(training_cfg: Dict[str, Any],
                       bindings: Optional[BindingsConfig] = None
                       ) -> Dict[str, float]:
    """Defaults < per-loss ``weight`` fields in the bindings (where the
    original bindings carry them) < the training YAML's loss_weights
    section."""
    w = dict(DEFAULT_WEIGHTS)
    if bindings is not None:
        for name, spec in (bindings.losses or {}).items():
            key = _LOSS_WEIGHT_KEY.get(name)
            if key and isinstance(spec, dict) and "weight" in spec:
                w[key] = float(spec["weight"])
        ph = (bindings.losses or {}).get("soft_neighborhood_phase") or \
            (bindings.losses or {}).get("phase_neighborhood") or {}
        if "phase_type_leakage_weight" in ph:
            w["type_leakage"] = float(ph["phase_type_leakage_weight"])
    w.update(training_cfg.get("loss_weights", {}) or {})
    return w


def build_sampler(bindings: BindingsConfig,
                  training_cfg: Dict[str, Any]) -> AnchorSampler:
    name = training_cfg.get("sampling_strategy", "grid-plus-supplement")
    if name in bindings.sampling_strategies:
        return build_anchor_sampler(bindings.get_sampling_strategy(name))
    return build_anchor_sampler({"stride": 16, "exclude_border": 16,
                                 "jitter": {"radius": 4}})


def build_curricula(training_cfg: Dict[str, Any],
                    bindings: Optional[BindingsConfig] = None
                    ) -> Dict[str, Any]:
    """Training-YAML curriculum keys win; absent ones fall back to the
    original project's placement: per-loss ``curriculum: {start_epoch,
    ramp_epochs}`` blocks inside the bindings' phase losses drive the phase
    gate."""
    cur = training_cfg.get("curriculum", {}) or {}
    phase_start, phase_ramp = 0, 1
    if bindings is not None:
        blocks = []
        for name in ("phase_neighborhood", "phase_spread_ranking",
                     "phase_recovery_discrimination"):
            c = ((bindings.losses or {}).get(name) or {}).get("curriculum")
            if isinstance(c, dict):
                blocks.append((int(c.get("start_epoch", 0)),
                               int(c.get("ramp_epochs", 1)), name))
        if blocks:
            # One gate for all phase losses: the EARLIEST block (start and
            # ramp from the same loss), with a warning when the per-loss
            # schedules disagree (the original gates each loss on its own).
            blocks.sort()
            phase_start, phase_ramp, _ = blocks[0]
            if len({(s, r) for s, r, _ in blocks}) > 1:
                import warnings
                warnings.warn(
                    "bindings declare divergent per-loss phase curricula "
                    f"{[(n, s, r) for s, r, n in blocks]}; this repo's "
                    "single phase gate uses the earliest "
                    f"(start={phase_start}, ramp={phase_ramp}) -- set "
                    "training curriculum.phase_start_epoch explicitly to "
                    "override", stacklevel=2)
    return {
        "input_dropout": cur.get("input_dropout", 0.0),
        "smoothing_freeze_until": cur.get("smoothing_freeze_until", 0),
        "smoothing_ramp_epochs": cur.get("smoothing_ramp_epochs", 1),
        "phase_start_epoch": cur.get("phase_start_epoch", phase_start),
        "phase_ramp_epochs": cur.get("phase_ramp_epochs", phase_ramp),
        "phase_ramped_losses": cur.get(
            "phase_ramped_losses",
            ["phase_neighborhood", "phase_spread", "recovery_disc",
             "vicreg_phase", "type_leakage"]),
    }


__all__ = ["build_step_config", "build_loss_weights", "build_sampler",
           "build_curricula"]
