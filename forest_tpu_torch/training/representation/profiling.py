"""Opt-in profiling: the ``--profile`` flag, step timers, a profiler trace.

Port of ``forest_tpu/training/representation/profiling.py``. With the flag
on, the CLI wraps its first trained epoch in :func:`maybe_trace`, which
here is a ``torch.profiler`` trace of the host and (on a card) the device,
written as a Chrome trace (``trace.json``) into the given directory.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

_PROFILE = False


def set_profile(on: bool) -> None:
    global _PROFILE
    _PROFILE = bool(on)


def is_profiling() -> bool:
    return _PROFILE


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace when profiling is on and a logdir is
    given; written to ``<logdir>/trace.json`` when the block ends."""
    if not (_PROFILE and logdir):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimers:
    """mark_* timers (the legacy vqvae.train_debug_utils contract)."""

    def __init__(self):
        self.t: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.t[name] = self.t.get(name, 0.0) + (now - self._last)
        self._last = now

    mark_load = lambda self: self.mark("load")          # noqa: E731
    mark_fwd = lambda self: self.mark("fwd")            # noqa: E731
    mark_bwd = lambda self: self.mark("bwd")            # noqa: E731
    mark_opt = lambda self: self.mark("opt")            # noqa: E731

    def consume(self) -> Dict[str, float]:
        out, self.t = self.t, {}
        self._last = time.perf_counter()
        return out


def print_device_summary() -> str:
    """The visible CUDA devices with the memory in use and their total
    (the legacy ``print_device_summary`` contract); 'cuda: none' without
    a card."""
    import torch

    if not torch.cuda.is_available():
        lines = ["cuda: none"]
    else:
        lines = [f"cuda devices: {torch.cuda.device_count()}"]
        for i in range(torch.cuda.device_count()):
            total = torch.cuda.get_device_properties(i).total_memory
            used = torch.cuda.memory_allocated(i)
            lines.append(f"  {i}: {torch.cuda.get_device_name(i)}  mem "
                         f"{used / 2**30:.2f}/{total / 2**30:.2f} GiB")
    out = "\n".join(lines)
    print(out)
    return out


__all__ = ["set_profile", "is_profiling", "maybe_trace", "StepTimers",
           "print_device_summary"]
