"""Host ms a batch inside the dataset's ``load_batch`` (the region of the loader workers' ``loader.load`` span: read, decode, assemble) over the window's CLI epochs."""
from gpu_bench import epochs


def read(run):
    seconds = epochs.window_sum(run, "load_s")
    loads = epochs.window_sum(run, "loads")
    if seconds is None or not loads:
        return None
    return 1e3 * seconds / loads
