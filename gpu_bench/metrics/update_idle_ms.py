"""Host time inside the train step's ``step.update`` span with nothing on the device, ms a unit."""
from gpu_bench import spans


def read(run):
    return spans.idle_ms(run.trace, "step.update")
