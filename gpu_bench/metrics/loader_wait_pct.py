"""The share of the window's CLI epochs that the loop spent waiting for the loader's next batch: ``run_epoch``'s summed ``wait_s`` over its summed ``epoch_time_s``, %."""
from gpu_bench import epochs


def read(run):
    wait = epochs.window_sum(run, "wait_s")
    total = epochs.window_sum(run, "epoch_time_s")
    if wait is None or not total:
        return None
    return 100.0 * wait / total
