"""The share of the device stretch's host time with no kernel, copy or set on the card, %."""


def read(run):
    if run.busy is None or run.busy.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.busy.busy_s / run.busy.window_s)
