"""Device time of the work launched inside the train step's ``step.backward`` span (the gradients, autograd's device thread included), ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.device_ms(run.trace, "step.backward")
