"""Device time of the work launched inside the ``model.phase_encoder`` span (TCN, bottleneck, FiLM), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "model.phase_encoder")
