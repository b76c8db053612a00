"""K1's least time over the device time of the kernels launched under forest_tpu_torch::bank_mix_fwd, %."""
from gpu_bench import trace
from gpu_bench.costs import kernels

OP = "bank_mix_fwd"


def read(run):
    if run.trace is None:
        return None
    return trace.roofline_pct(run.trace, OP, lambda dims, dtype: kernels.
                              bound_s(kernels.op_cost(OP, dims, dtype)))
