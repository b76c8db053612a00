"""Opt-in profiling: the ``--profile`` flag and a profiler trace.

Port of ``forest_tpu/training/representation/profiling.py``. With the flag
on, the CLI wraps its first trained epoch in :func:`maybe_trace`, which
here is a ``torch.profiler`` trace of the host's threads (the loader's
workers among them) and, on a card, the device, written as a Chrome trace
(``trace.json``) into the given directory. The program's spans
(``utils.spans``: the loop's, the loader's, the step's stages, the
encoders', the feature builds) are ranges in it, on the device events'
clock.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

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
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    # every thread, so the loader workers' spans are in the trace too
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


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


__all__ = ["set_profile", "is_profiling", "maybe_trace",
           "print_device_summary"]
