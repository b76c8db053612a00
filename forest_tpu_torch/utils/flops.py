"""A step's FLOPs and its MFU (model FLOPs utilization) on an H100.

Port of ``forest_tpu/utils/flops.py``. The JAX module reads a step's FLOPs
from XLA's cost model of the compiled step, which takes each Pallas call's
``pl.CostEstimate`` for the kernel's work. Here the step runs once under
``torch.utils.flop_counter.FlopCounterMode``:

- every hand-written kernel the package calls is a ``torch.library`` op in
  the namespace ``forest_tpu_torch`` (``ops/_library.py``; ``ops/
  smoothing.py``, ``ops/scatter.py``, ``ops/vq.py``) whose FLOP formula is
  its declared cost, a :class:`KernelCost` (the counterpart of
  ``pl.CostEstimate``), and whose gradient, where it has one, is another
  such op. The counter sees the op and not its body, so
  a kernel counts the same whether the card's kernel or the CPU's plain
  version runs it, and the whole step counts the same on both;
- the rest of the step counts as ``FlopCounterMode`` counts it: matrix
  products and convolutions (2 FLOPs a multiply-add), nothing for
  elementwise operations, reductions, gathers or the optimizer's update.
  XLA also counts those, so a JAX step's count is the higher.

:func:`step_flops` is the counterpart of ``compiled_flops``; :func:`mfu` and
:func:`mfu_fields` keep the JAX module's arithmetic and keys, against the
published dense peaks of one NVIDIA H100 SXM at 700 W (:data:`PEAK_TFLOPS`).
:func:`bound_s` is the least time a kernel's declared cost can take on it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

# Published dense peaks, TFLOP/s: one NVIDIA H100 SXM at its 700 W limit
# (the tensor cores in bfloat16 and in TF32, float32 outside them). A card
# set below 700 W runs below these; write its power limit beside an MFU.
# ``a40_bf16`` is the reference trainer's card (an NVIDIA A40 at 300 W),
# used only for the reference's implied MFU.
PEAK_TFLOPS = {
    "h100_bf16_dense": 989.4,
    "h100_tf32_dense": 494.7,
    "h100_f32": 66.9,
    "a40_bf16": 149.7,
}
# the H100 rows: mfu_fields' denominators unless the caller names others
H100_PEAKS = {k: v for k, v in PEAK_TFLOPS.items() if k.startswith("h100_")}
# the H100's device memory (HBM3), bytes per second
PEAK_BYTES_PER_S = 3.35e12
# The float32 and bfloat16 (tensor cores, dense) rates, FLOP/s, a kernel's
# bound reads: the same card's peaks rounded to 67 and 989 TFLOP/s, as the
# port's kernel bounds have always been stated, so that a kernel's bound
# compares with its earlier records to the bit. 67 lies 0.15 % above
# PEAK_TFLOPS' 66.9 and 989 0.04 % below its 989.4, far inside what
# separates a kernel from its bound; an MFU reads PEAK_TFLOPS.
BOUND_PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

# The reference's production headline: ~1.1 s/batch at B=12, 256^2 patches
# on an A40 (BASELINE.md).
REFERENCE_FRL_S_PER_BATCH = 1.1


class KernelCost(NamedTuple):
    """The work of one call of a kernel, as ``pl.CostEstimate`` states a
    Pallas call's: FLOPs (2 a multiply-add, 1 an add of a reduction), the
    bytes it must move (each input read once, each output written once) and
    its transcendental operations."""
    flops: int
    bytes_accessed: int
    transcendentals: int = 0


def bound_s(cost: KernelCost, peak_flops: float) -> Tuple[float, str]:
    """-> (seconds, "bytes" | "operations"): the least time one call of
    ``cost`` can take, the larger of its bytes over
    :data:`PEAK_BYTES_PER_S` and its FLOPs over ``peak_flops`` (FLOP/s),
    and which of the two it is."""
    by_bytes = cost.bytes_accessed / PEAK_BYTES_PER_S
    by_ops = cost.flops / peak_flops
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def flops_by_op(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and return
    the FLOPs it counted, by operator (``aten.convolution``,
    ``forest_tpu_torch.bank_mix_fwd``, ...). Operators it counts nothing
    for are left out."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {str(op): int(n) for op, n in
            counter.get_flop_counts().get("Global", {}).items() if n}


def step_flops(fn: Callable, *args, **kwargs) -> int:
    """FLOPs of one call of ``fn(*args, **kwargs)``: everything it computes
    (forward, backward and update of a training step), each hand-written
    kernel by its declared cost, the rest as ``FlopCounterMode`` counts it.
    ``fn`` runs once, on whatever device its tensors are on.

    Raises what ``fn`` raises, and ``ValueError`` where nothing was counted
    (an MFU of 0 would read as a measurement): a count is never NaN."""
    total = sum(flops_by_op(fn, *args, **kwargs).values())
    if total <= 0:
        raise ValueError(f"step_flops: {getattr(fn, '__name__', fn)!r} ran "
                         f"no operation that FlopCounterMode counts")
    return total


def mfu(flops_per_step: float, seconds_per_step: float,
        peak_tflops: float) -> float:
    """Fraction of ``peak_tflops`` sustained: in [0, 1] for honest inputs."""
    return flops_per_step / seconds_per_step / (peak_tflops * 1e12)


def mfu_fields(prefix: str, flops_per_step: float, seconds_per_step: float,
               peaks: Optional[Dict[str, float]] = None) -> dict:
    """Benchmark fields for one measured step.

    Returns ``{prefix}_gflops``, ``{prefix}_tflops_per_s`` and one
    ``{prefix}_mfu_pct_<peak>`` per denominator (:data:`H100_PEAKS` unless
    ``peaks`` names others); ``{prefix}_gflops`` -1.0 alone where the FLOPs
    are not a positive finite number or the time is not positive."""
    if not (math.isfinite(flops_per_step) and flops_per_step > 0
            and seconds_per_step > 0):
        return {f"{prefix}_gflops": -1.0}
    achieved = flops_per_step / seconds_per_step
    out = {f"{prefix}_gflops": round(flops_per_step / 1e9, 2),
           f"{prefix}_tflops_per_s": round(achieved / 1e12, 3)}
    for name, peak in (peaks or H100_PEAKS).items():
        out[f"{prefix}_mfu_pct_{name}"] = round(
            100.0 * mfu(flops_per_step, seconds_per_step, peak), 2)
    return out


__all__ = ["PEAK_TFLOPS", "H100_PEAKS", "PEAK_BYTES_PER_S",
           "BOUND_PEAK_FLOPS", "REFERENCE_FRL_S_PER_BATCH", "KernelCost",
           "bound_s", "flops_by_op", "step_flops", "mfu", "mfu_fields"]
