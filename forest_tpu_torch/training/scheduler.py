"""Learning-rate schedules: step count -> learning rate (plain floats).

Port of ``forest_tpu/training/scheduler.py``, with the formulas of the
optax schedules it is built from written out:

- :func:`cosine_lr`: linear warm-up from 0 to ``lr`` over ``warmup_steps``,
  then a cosine from ``lr`` to ``min_lr`` until ``total_steps``;
- :func:`two_phase_cosine_lr`: the same, multiplied from
  ``phase_start_step`` on by a factor that ramps from ``start_factor`` to
  ``peak_factor`` over ``rewarmup_steps`` and stays there (the optimizer's
  second-moment state is cold for the parameters that become active then).
  The original project instead restarts a fresh cosine at that step; this
  port keeps the JAX package's behaviour, a known divergence;
- :func:`resume_cosine_lr`: a fresh cosine over the remaining steps;
- :func:`warmup_cosine_decay_schedule`: optax's function of that name, term
  for term (a linear ramp ``(init - peak) * (1 - c / warmup) + peak``, then
  a cosine over ``decay_steps - warmup_steps``), which the SGD probe of
  ``eval/train_probe.py`` trains with.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _cosine_decay(init_value: float, decay_steps: int,
                  alpha: float) -> Schedule:
    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def cosine_lr(lr: float, total_steps: int, min_lr: float = 0.0,
              warmup_steps: int = 0) -> Schedule:
    if warmup_steps <= 0:
        return _cosine_decay(lr, max(total_steps, 1),
                             min_lr / max(lr, 1e-12))
    decay_steps = max(total_steps, warmup_steps + 1)
    cosine = _cosine_decay(lr, decay_steps - warmup_steps,
                           0.0 if lr == 0.0 else min_lr / lr)

    def schedule(count):
        if count < warmup_steps:
            return lr * max(float(count), 0.0) / warmup_steps
        return cosine(count - warmup_steps)

    return schedule


def two_phase_cosine_lr(lr: float, total_steps: int, phase_start_step: int,
                        rewarmup_steps: int, min_lr: float = 0.0,
                        warmup_steps: int = 0, start_factor: float = 0.1,
                        peak_factor: float = 1.0) -> Schedule:
    base = cosine_lr(lr, total_steps, min_lr, warmup_steps)

    def schedule(step):
        t = step - phase_start_step
        if t < 0:
            return base(step)
        u = min(max(t / max(rewarmup_steps, 1), 0.0), 1.0)
        factor = start_factor + (peak_factor - start_factor) * u
        return base(step) * (peak_factor if t >= rewarmup_steps else factor)

    return schedule


def resume_cosine_lr(lr: float, remaining_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    return cosine_lr(lr, remaining_steps, min_lr, warmup_steps=0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): ``linear_schedule``
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, joined at
    that step to ``cosine_decay_schedule(peak_value, decay_steps -
    warmup_steps, end_value / peak_value)``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine needs positive decay steps, got "
                         f"{decay_steps} - {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = _cosine_decay(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count):
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = 1.0 - min(max(float(count), 0.0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    return schedule


__all__ = ["cosine_lr", "two_phase_cosine_lr", "resume_cosine_lr",
           "warmup_cosine_decay_schedule"]
