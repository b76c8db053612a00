"""The host's mean time in one unit's call over the window, ms."""


def read(run):
    return 1e3 * sum(run.window.spans) / run.window.units
