"""Device time of the work launched inside the ``data.features`` spans (FeatureBuilder's builds), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "data.features")
