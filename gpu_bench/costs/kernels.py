# Frozen copy of the kernels' cost formulas of forest_tpu_torch/ops/smoothing.py, ops/scatter.py and the peaks of utils/flops.py at 3cfd860c7617988dff336bd92534bbc78565c650.
"""The work of one call of each hand-written kernel, the card's peaks and a
call's least time.

A cost is (FLOPs, bytes): 2 FLOPs a multiply-add, 1 an add of a reduction;
each input read once and each output written once. The FLOPs of K1-K3 run
on the CUDA cores in float32 whatever the storage type, so their bound
reads them against the float32 peak.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989.4e12, "tf32": 494.7e12, "float32": 66.9e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


class Cost(NamedTuple):
    flops: int
    bytes: int


def bound_s(cost: Cost, peak_flops: float = PEAK_FLOPS["float32"]) -> float:
    """The least time one call can take: the larger of its bytes over the
    memory's peak and its FLOPs over ``peak_flops``."""
    return max(cost.bytes / PEAK_BYTES_PER_S, cost.flops / peak_flops)


def bank_mix_fwd(x_shape: Sequence[int], rank: int, num_directions: int = 4,
                 itemsize: int = 4) -> Cost:
    """K1 on x [B, H, W, C]: per output element K = 2 num_directions 3-tap
    means (3 FLOPs each), R sums over K (2 K each) and R products with B;
    x, A [.., K, R] and B [.., C, R] read once, the output written once."""
    b, h, w, c = x_shape
    k, r, pix = 2 * num_directions, rank, b * h * w
    return Cost(pix * c * (3 * k + 2 * k * r + 2 * r),
                itemsize * pix * (2 * c + k * r + c * r))


def bank_mix_bwd(x_shape: Sequence[int], rank: int, num_directions: int = 4,
                 itemsize: int = 4) -> Cost:
    """K2: per element of x, dx visits the 2 K + 1 taps ((2 R + 1) FLOPs
    each) and the centre's R sums over K (2 K R), f_k again (3 K), dB
    (R (2 K + 1)) and dA's share (2 K R); x, g, A, B read once and dx, dA,
    dB written once."""
    b, h, w, c = x_shape
    k, r, pix = 2 * num_directions, rank, b * h * w
    per = ((2 * k + 1) * (2 * r + 1) + 2 * k * r + 3 * k + r * (2 * k + 1)
           + 2 * k * r)
    return Cost(pix * c * per,
                itemsize * pix * (3 * c + 2 * k * r + 2 * c * r))


def scatter_add_rows(dz_shape: Sequence[int], n_rows: int) -> Cost:
    """K3 on dz [B, N, C] (float32, int32 indices) into [B, n_rows, C]."""
    b, n, c = dz_shape
    return Cost(b * n * c, 4 * b * n * c + 4 * b * n + 4 * b * n_rows * c)


def op_cost(op: str, dims: Sequence[Tuple[int, ...]],
            dtype: str) -> Cost:
    """The cost of one call of the port's op ``forest_tpu_torch::<op>``
    from its inputs' shapes ``dims`` and its first input's type, as a
    profiler records them."""
    size = ITEMSIZE.get(dtype, 4)
    if op == "bank_mix_fwd":
        return bank_mix_fwd(dims[0], dims[1][-1], dims[1][-2] // 2, size)
    if op == "bank_mix_bwd":
        return bank_mix_bwd(dims[0], dims[1][-1], dims[1][-2] // 2, size)
    raise KeyError(f"no cost formula for {op}")
