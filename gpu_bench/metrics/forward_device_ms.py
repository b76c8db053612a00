"""Device time of the work launched inside the train step's ``step.forward`` span (the decode and ``process_batch``), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "step.forward")
