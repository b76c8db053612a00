"""The least time of a unit's FLOPs at the peak of each part's precision, over the window's time a unit, %."""
from gpu_bench.costs import kernels
from gpu_bench.metrics import _read


def read(run):
    least = sum(f / kernels.PEAK_FLOPS[p] for p, f in run.flops.items())
    return 100.0 * least / _read.unit_s(run)
