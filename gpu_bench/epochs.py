"""The program's own clocks of each timed unit, kept by a driver whose unit
is a training CLI's epoch, for the metric readers.

A driver records, for the harness's unit ``i``, ``run_epoch``'s ``wait_s``
(the loader's hand-over, the ``loader.wait`` span's region) and
``epoch_time_s``, and the host seconds and count of the dataset's
``load_batch`` calls made by the loader's workers (the ``loader.load``
span's region). The window's units are ``0 .. run.window.units - 1``; a
reader sums over them and reads None where a unit was not recorded.
"""
from __future__ import annotations

from typing import Dict, Optional

UNITS: Dict[int, Dict[str, float]] = {}


def record(i: int, **clocks: float) -> None:
    UNITS[i] = dict(clocks)


def window_sum(run, key: str) -> Optional[float]:
    """``key`` summed over the window's units, or None."""
    units = [UNITS.get(i) for i in range(run.window.units)]
    if not units or any(u is None or key not in u for u in units):
        return None
    return sum(u[key] for u in units)
