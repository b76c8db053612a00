"""K9's least time over the device time of the kernels launched under
forest_tpu_torch::tcn_block, %. A call's cost needs its dilation, a scalar
argument the profiler records among the call's concrete inputs, so this
reader sums the calls itself over ``trace.op_kernels`` (what
``trace.roofline_pct`` does from the input shapes alone); a call without
them is costed at the dilation with the fewest taps inside the series."""
from gpu_bench import trace
from gpu_bench.costs import kernels, tcn

OP = "tcn_block"
DILATION_ARG = 13           # the op's schema: x, 12 tensors, dilation


def dilation(call):
    concrete = call.get("args", {}).get("Concrete Inputs", [])
    try:
        return int(concrete[DILATION_ARG])
    except (IndexError, ValueError):
        return None


def read(run):
    if run.trace is None:
        return None
    calls, seconds = run.trace.op_kernels(OP)
    if not calls or seconds <= 0.0:
        return None
    least = sum(kernels.bound_s(tcn.tcn_block(trace.input_dims(c)[0],
                                              dilation(c)))
                for c in calls)
    return 100.0 * least / seconds
