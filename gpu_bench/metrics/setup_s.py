"""Set-up: process start to the first timed unit, s."""


def read(run):
    return run.setup_s
