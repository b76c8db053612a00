"""What the metric readers share. A reader ``metrics/<name>.py``, or
``metrics/<kind>.py`` for every metric named ``<kind>.<anything>``, has
``read(run)`` -> a number, or None where it finds nothing to read. ``run``
holds ``setup_s``; ``window`` (``units``, ``failed``, ``items``,
``seconds``, ``spans``: each unit's host seconds); ``busy`` (the device
stretch, traced for device activity alone: ``units``, ``busy_s``,
``window_s``) and ``trace`` (a ``gpu_bench.trace.Trace`` of the stretch
traced with the host's operators and their shapes), both None without
``--trace 1``; ``traffic``; and ``flops`` (a unit's FLOPs by
precision)."""
from __future__ import annotations


def rate(run) -> float:
    """Items completed over the whole window, a second."""
    return run.window.items / run.window.seconds


def unit_s(run) -> float:
    """The window's time a unit, by the host's clock."""
    return run.window.seconds / run.window.units
