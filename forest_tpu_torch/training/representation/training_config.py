"""Training configuration parser (the three-file YAML scheme).

Port of ``forest_tpu/training/representation/training_config.py``, copied
whole: it is YAML and dataclasses. The training YAML names the bindings and
model YAMLs and holds the run / checkpoint / hardware / epoch / optimizer /
scheduler / curriculum / spatial-domain blocks; typed dataclasses take a
default for every missing key; ``validate()`` and ``summary()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class CheckpointConfig:
    save_every_n_epochs: int = 5
    save_top_k: int = 3
    monitor: str = "val/loss_total"
    mode: str = "min"
    save_last: bool = True
    monitor_start_epoch: int = 0


@dataclass
class RunConfig:
    experiment_name: str = "frl_exp"
    run_root: str = "runs"
    ckpt_dir: str = "checkpoints"
    log_dir: str = "logs"
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    @property
    def experiment_dir(self) -> Path:
        return Path(self.run_root) / self.experiment_name


@dataclass
class HardwareConfig:
    num_workers: int = 8
    prefetch_factor: int = 2
    # Shard batches over all visible devices. The port trains on one card:
    # train_representation refuses this with more than one visible.
    data_parallel: bool = False
    # hardware.mixed_precision of the original schema: honoured as the
    # spatial-conv compute-dtype default (train_representation.
    # apply_mixed_precision). None = disabled.
    mixed_precision_dtype: Optional[str] = None


@dataclass
class EpochConfig:
    num_epochs: int = 400
    mode: str = "number"           # full | frac | number
    sample_frac: float = 0.1
    sample_number: int = 512
    batch_size: int = 12


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0


@dataclass
class SchedulerConfig:
    warmup_epochs: int = 5
    min_lr_factor: float = 0.1
    phase_rewarmup: bool = True
    rewarmup_epochs: int = 10
    start_factor: float = 0.1
    peak_factor: float = 1.0


@dataclass
class SpatialDomainConfig:
    patch_size: int = 256
    split_block_size: Tuple[int, int] = (4, 4)
    min_aoi: float = 0.3
    debug_window: Optional[Tuple[int, int, int, int]] = None  # r0,r1,c0,c1


@dataclass
class TrainingConfiguration:
    version: str = "1.0"
    name: str = ""
    bindings_path: str = ""
    model_path: str = ""
    run: RunConfig = field(default_factory=RunConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)
    epoch: EpochConfig = field(default_factory=EpochConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    spatial_domain: SpatialDomainConfig = field(
        default_factory=SpatialDomainConfig)
    curriculum: Dict[str, Any] = field(default_factory=dict)
    loss_weights: Dict[str, float] = field(default_factory=dict)
    step: Dict[str, Any] = field(default_factory=dict)
    sampling_strategy: str = "grid-plus-supplement"
    # model-input feature names (model_input.* keys or the original
    # YAML's model.type_encoder_feature / model.phase_encoder_feature)
    model_input: Dict[str, Any] = field(default_factory=dict)
    # the step's diagnostics (distribution stats, tau sweeps, leakage
    # ridge), computed every step as the original project does
    diagnostics: bool = True
    validation: Dict[str, Any] = field(default_factory=dict)
    early_stopping: Dict[str, Any] = field(default_factory=dict)
    seed: int = 0

    def validate(self) -> None:
        checks = {"epoch.batch_size > 0": self.epoch.batch_size > 0,
                  "epoch.num_epochs > 0": self.epoch.num_epochs > 0,
                  "epoch.mode in full | frac | number":
                      self.epoch.mode in ("full", "frac", "number"),
                  "optimizer.lr > 0": self.optimizer.lr > 0,
                  "spatial_domain.patch_size > 0":
                      self.spatial_domain.patch_size > 0}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise ValueError(f"training config: {failed} do not hold")

    def summary(self) -> str:
        return (f"TrainingConfiguration(name={self.name!r}, "
                f"epochs={self.epoch.num_epochs}, "
                f"batch={self.epoch.batch_size}, "
                f"patch={self.spatial_domain.patch_size}, "
                f"lr={self.optimizer.lr})")

    def as_builder_dict(self) -> Dict[str, Any]:
        """The dict shape config_builders expects."""
        return {
            "loss_weights": self.loss_weights,
            "step": self.step,
            "curriculum": self.curriculum,
            "sampling_strategy": self.sampling_strategy,
            "model_input": self.model_input,
        }


def _smoothing_curriculum(raw: Dict[str, Any]) -> Dict[str, Any]:
    ssc = raw.get("spatial_smoothing_curriculum") or {}
    if not ssc or not ssc.get("enabled", True):
        return {}
    out: Dict[str, Any] = {}
    if "freeze_until_epoch" in ssc:
        out["smoothing_freeze_until"] = int(ssc["freeze_until_epoch"])
    if "ramp_epochs" in ssc:
        out["smoothing_ramp_epochs"] = int(ssc["ramp_epochs"])
    return out


def parse_training_config(path_or_dict) -> TrainingConfiguration:
    if isinstance(path_or_dict, (str, Path)):
        raw = yaml.safe_load(Path(path_or_dict).read_text()) or {}
    else:
        raw = path_or_dict or {}

    run_raw = raw.get("run", {}) or {}
    ck = run_raw.get("checkpoint", {}) or {}
    tr = raw.get("training", {}) or {}
    ep = tr.get("epoch", {}) or {}
    opt = raw.get("optimizer", {}) or {}
    sched = raw.get("scheduler", {}) or {}
    sd = raw.get("spatial_domain", {}) or {}
    hw = raw.get("hardware", {}) or {}
    cfgrefs = raw.get("config", {}) or {}

    dbg = sd.get("debug_window")
    cfg = TrainingConfiguration(
        version=str(raw.get("version", "1.0")),
        name=raw.get("name", ""),
        bindings_path=cfgrefs.get("bindings_path", ""),
        model_path=cfgrefs.get("model_path", ""),
        run=RunConfig(
            experiment_name=run_raw.get("experiment_name", "frl_exp"),
            run_root=run_raw.get("run_root", "runs"),
            ckpt_dir=run_raw.get("ckpt_dir", "checkpoints"),
            log_dir=run_raw.get("log_dir", "logs"),
            checkpoint=CheckpointConfig(
                save_every_n_epochs=ck.get("save_every_n_epochs", 5),
                save_top_k=ck.get("save_top_k", 3),
                monitor=ck.get("monitor", "val/loss_total"),
                mode=ck.get("mode", "min"),
                save_last=ck.get("save_last", True),
                monitor_start_epoch=ck.get("monitor_start_epoch", 0))),
        hardware=HardwareConfig(
            num_workers=hw.get("num_workers", 8),
            prefetch_factor=hw.get("prefetch_factor", 2),
            data_parallel=hw.get("data_parallel", False),
            mixed_precision_dtype=(
                (hw.get("mixed_precision", {}) or {}).get(
                    "dtype", "bfloat16")
                if (hw.get("mixed_precision", {}) or {}).get("enabled")
                else None)),
        epoch=EpochConfig(
            num_epochs=ep.get("num_epochs", 400),
            mode=ep.get("mode", "number"),
            sample_frac=ep.get("sample_frac", 0.1),
            sample_number=ep.get("sample_number", 512),
            batch_size=ep.get("batch_size", 12)),
        optimizer=OptimizerConfig(
            name=opt.get("name", "adamw"), lr=opt.get("lr", 1e-4),
            weight_decay=opt.get("weight_decay", 1e-4),
            grad_clip=(tr.get("gradient_clip", {}) or {}).get(
                "max_norm", opt.get("grad_clip", 1.0))),
        scheduler=SchedulerConfig(
            warmup_epochs=sched.get("warmup_epochs", 5),
            min_lr_factor=sched.get("min_lr_factor", 0.1),
            phase_rewarmup=sched.get("phase_rewarmup", True),
            rewarmup_epochs=sched.get("rewarmup_epochs", 10),
            start_factor=sched.get("start_factor", 0.1),
            peak_factor=sched.get("peak_factor", 1.0)),
        spatial_domain=SpatialDomainConfig(
            patch_size=sd.get("patch_size", 256),
            split_block_size=tuple(sd.get("split_block_size", (4, 4))),
            min_aoi=sd.get("min_aoi", 0.3),
            debug_window=tuple(dbg) if dbg else None),
        # the original project's YAMLs carry the smoothing curriculum in a
        # top-level spatial_smoothing_curriculum section; explicit
        # curriculum keys win over it
        curriculum={**_smoothing_curriculum(raw),
                    **(raw.get("curriculum", {}) or {})},
        loss_weights=raw.get("loss_weights", {}) or {},
        step=raw.get("step", {}) or {},
        sampling_strategy=raw.get("sampling_strategy",
                                  "grid-plus-supplement"),
        # merge per-key: model_input keys win over the original
        # YAML's model section (both may appear in a partially-ported cfg)
        model_input={**(raw.get("model", {}) or {}),
                     **(raw.get("model_input", {}) or {})},
        diagnostics=bool(tr.get("diagnostics",
                                raw.get("diagnostics", True))),
        validation=(tr.get("validation", {}) or {}),
        early_stopping=(tr.get("early_stopping", {}) or {}),
        seed=raw.get("seed", 0),
    )
    cfg.validate()
    return cfg


__all__ = ["TrainingConfiguration", "parse_training_config",
           "CheckpointConfig", "RunConfig", "EpochConfig",
           "OptimizerConfig", "SchedulerConfig", "SpatialDomainConfig",
           "HardwareConfig"]
