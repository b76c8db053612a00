"""The 95th percentile of the window's batches, dispatch to outputs complete, ms."""
import statistics


def read(run):
    return statistics.quantiles(run.window.spans, n=20,
                                method="inclusive")[-1] * 1e3
