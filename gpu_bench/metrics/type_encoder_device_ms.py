"""Device time of the work launched inside the ``model.type_encoder`` span (encoder and smoothing block, K1), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "model.type_encoder")
