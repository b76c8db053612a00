"""The work of one call of the port's op ``forest_tpu_torch::tcn_block``
(K9: one gated residual block of the phase TCN, and in the last block the
head and FiLM), from the call's input shapes as a profiler records them.

A cost is (FLOPs, bytes), 2 FLOPs a multiply-add, in float32 on the CUDA
cores: the conv's taps that fall inside the series (a tap on the zero
padding is work the kernel need not do), the gate's product, the
projection's and the head's; the input, the output, FiLM's gamma and beta
and the weights each moved once. Elementwise work (GroupNorm, the sigmoid,
the mix) is not counted. So the bound, max(bytes / 3.35 TB/s, FLOPs / 66.9
TFLOP/s), is a least time the kernel cannot beat.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from gpu_bench.costs.kernels import Cost

# the dilations the tiled kernel runs (the v1 model's); where a trace does
# not give a call's own, the one with the fewest taps inside the series
DILATIONS = (1, 2, 4)


def taps_inside(steps: int, dilation: int) -> int:
    """The (step, tap) pairs of a 3-tap conv at ``dilation`` whose input
    lies inside a series of ``steps``."""
    return steps + 2 * max(0, steps - dilation)


def tcn_block(dims: Sequence[Tuple[int, ...]],
              dilation: Optional[int] = None) -> Cost:
    """One call on inputs of shapes ``dims``, in the op's order: x [N, T,
    C_in] or [B, T, H, W, C_in], the conv's weight [C_out, C_in, 3] and
    bias, GroupNorm's weight and bias, the gate's weight and bias, the
    projection's (empty: none), the head's [Z, C_out] and bias (empty:
    none), gamma and beta [N, Z] (empty: none)."""
    x, conv_w = dims[0], dims[1]
    c_out, c_in, _ = conv_w
    steps = x[1]
    n = math.prod(x) // (steps * x[-1])
    taps = (taps_inside(steps, dilation) if dilation is not None
            else min(taps_inside(steps, d) for d in DILATIONS))
    projected = len(dims[7]) > 0
    z = dims[9][0] if len(dims[9]) > 0 else 0
    macs = (taps * c_in * c_out + steps * (c_out * c_out + z * c_out
                                           + (c_in * c_out if projected
                                              else 0)))
    weights = sum(math.prod(d) for d in dims[1:11] if len(d) > 0)
    moved = (n * steps * (c_in + (z or c_out)) + weights
             + sum(math.prod(d) for d in dims[11:13] if len(d) > 0))
    return Cost(2 * n * macs, 4 * moved)
