"""Host synchronisations inside the traced units, a unit."""


def read(run):
    if run.trace is None or not run.trace.units:
        return None
    return run.trace.syncs() / len(run.trace.units)
