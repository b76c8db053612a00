"""Timestamped logging shim: log/warn/fail/ensure/timeit.

Port of ``forest_tpu/utils/log.py`` (behavioural contract from
original:utils/log.py:9-60, SURVEY.md §2.2), with :func:`pyplot` added:
the figures of the eval tools are optional on a machine without
matplotlib.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator


def _stamp() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def log(*msg) -> None:
    print(f"[{_stamp()}]", *msg, flush=True)


def warn(*msg) -> None:
    print(f"[{_stamp()}] WARNING:", *msg, file=sys.stderr, flush=True)


def fail(*msg, code: int = 1) -> None:
    print(f"[{_stamp()}] FATAL:", *msg, file=sys.stderr, flush=True)
    raise SystemExit(code)


def ensure(cond, *msg) -> None:
    if not cond:
        fail(*msg)


@contextlib.contextmanager
def timeit(label: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log(f"{label}: {time.perf_counter() - t0:.2f}s")


def pyplot(figure: str):
    """matplotlib's pyplot on the Agg backend, or None after one log line
    naming ``figure`` where matplotlib does not import (the card's machine
    has none): the caller then draws nothing, and writes its other
    artifacts all the same."""
    try:
        import matplotlib
    except ImportError:
        log(f"matplotlib does not import: skipped the figure {figure}")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


__all__ = ["log", "warn", "fail", "ensure", "timeit", "pyplot"]
