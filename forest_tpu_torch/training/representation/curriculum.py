"""Epoch -> scalar curricula (pure functions).

Port of ``forest_tpu/training/representation/curriculum.py``, copied whole:
the input-dropout schedule (constant / linear / cosine), the shared linear
0 -> 1 ``ramp_weight`` (zero AT start_epoch: the scheduler's phase
re-warmup relies on this) and the smoothing ``min_gate`` = 1 - ramp. The
epoch loop turns them into device scalars once per epoch.
"""
from __future__ import annotations

import math
from typing import Union


def compute_input_dropout_rate(schedule_cfg: Union[float, dict], epoch: int,
                               total_epochs: int) -> float:
    if isinstance(schedule_cfg, (int, float)):
        return float(schedule_cfg)
    schedule = schedule_cfg.get("schedule", "constant")
    if schedule == "constant":
        return float(schedule_cfg.get("rate", 0.0))
    start = float(schedule_cfg.get("start", 0.0))
    end = float(schedule_cfg.get("end", 0.1))
    ramp_epochs = int(schedule_cfg.get("epochs", total_epochs))
    t = min(epoch / max(ramp_epochs, 1), 1.0)
    if schedule == "linear":
        return start + t * (end - start)
    if schedule == "cosine":
        return start + (end - start) * (1 - math.cos(math.pi * t)) / 2
    raise ValueError(f"unknown input_dropout schedule {schedule!r}")


def ramp_weight(epoch: int, start_epoch: int, ramp_epochs: int) -> float:
    """Linear 0->1; exactly 0.0 at start_epoch."""
    if epoch < start_epoch:
        return 0.0
    if epoch >= start_epoch + ramp_epochs:
        return 1.0
    return (epoch - start_epoch) / ramp_epochs


def compute_smoothing_min_gate(epoch: int, freeze_until_epoch: int,
                               ramp_epochs: int) -> float:
    """1.0 (identity, smoothing frozen) -> 0.0 (unconstrained)."""
    return 1.0 - ramp_weight(epoch, freeze_until_epoch, ramp_epochs)


__all__ = ["compute_input_dropout_rate", "ramp_weight",
           "compute_smoothing_min_gate"]
