"""Device time of the work launched inside the train step's ``step.update`` span (norm, finite test, AdamW), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "step.update")
