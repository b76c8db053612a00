"""Patches embedded over the whole window, a second."""
from gpu_bench.metrics import _read


def read(run):
    return _read.rate(run)
