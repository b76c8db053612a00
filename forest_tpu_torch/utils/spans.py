"""Named ranges of the program in the profiler's own trace.

``with span("step.forward"): ...`` marks a stretch of the host's work as a
``torch.profiler.record_function`` range: it lands in the same Kineto trace
as the device's kernels, copies and sets, on their clock, so a device
event is put down to the span whose interval holds its launch, and an idle
gap on the device to the span the host was in. Names are
``<layer>.<part>``:

- ``step.forward`` / ``step.backward`` / ``step.allreduce`` /
  ``step.update``: the stages of the FRL train step (``step.forward`` also
  the eval step's);
- ``model.type_encoder`` / ``model.phase_encoder``: the type pathway
  (encoder and smoothing block) and the phase pathway of
  ``RepresentationModel``;
- ``data.features``: ``FeatureBuilder``'s builds;
- ``loader.wait`` / ``loader.load`` / ``loader.h2d`` and
  ``epoch.fetch_metrics``: the training CLI's epoch loop and loader.

With no profiler running, :func:`span` returns one shared no-op context:
a test of torch's own flag, under a microsecond a call, where an
unguarded ``record_function`` allocates its range object each time.
Nothing is stored or exported here: a trace is read where it is written
(``--profile``'s ``trace.json``, the benchmark's traced stretch).
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else the
    shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


__all__ = ["span"]
