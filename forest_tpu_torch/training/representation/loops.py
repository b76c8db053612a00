"""Epoch loops: iterate the loader, run the step, aggregate metrics.

Port of ``forest_tpu/training/representation/loops.py`` (``run_epoch``,
``train_epoch``, ``validate_epoch``) with its contract: batches are index
lists in dataset order after ``on_epoch_start()``; the ragged tail batch is
filled by repeating its last sample and de-weighted by the
``__sample_valid__`` mask the step honours; ``max_batches`` cuts the epoch;
epoch means weight each batch by its count of valid samples; the result
keeps ``n_steps``, ``epoch_time_s`` and the loader ``wait_s`` vs ``step_s``
split.

What belongs to PyTorch:

- the random source of step i is a ``torch.Generator`` on the training
  device seeded with ``rng_seed * 100003 + i``, the integer the JAX loop
  turns into its key (``generator.initial_seed()`` gives it back);
- batches cross to the device in the loader's consumer thread through
  ``data.loader.make_device_put`` (pinned memory, ``non_blocking``);
- metrics stay on the device and drain every ``_METRIC_SYNC_STEPS`` steps
  in one stacked copy to the host, so the loop adds no host
  synchronisation to a step's own;
- ``wire_compact=True`` puts the compact wire (``data.wire``) on the
  batches: the loader's consumer thread encodes each batch (floats to
  bfloat16 but the groups of ``wire_skip`` and the "categorical" ones)
  before its pinned copy, and the steps decode it on the device. It is
  off by default (the JAX loop turns it on only on a TPU), and no CLI of
  the port sets it: only the tests and ``chip_smoke.py`` turn it on.
  With the wire on in one process, the dataset assembles its batches
  channel-major (``set_wire_layout``) for the epoch; the layout is reset
  in ``finally`` after the loader is closed, so no prefetch worker still
  running sees the switch. Under several ranks the wire stays off, as in
  the JAX package;
- data parallel (``mesh`` of ``parallel.make_mesh`` with a group): every
  rank builds the same global index lists and loads only its rows
  ``[rank * B / W, (rank + 1) * B / W)`` of each, with its slice of the
  global validity mask (the repeat-filled tail batch included), and the
  step reduces across the ranks (``parallel.dp.make_dp_frl_step``). As in
  the JAX package, losses normalise over the rank's own valid samples and
  gradients are averaged with equal weight per rank.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.loader import PrefetchLoader, make_device_put
from forest_tpu_torch.data.wire import encode_wire_batch
from forest_tpu_torch.parallel.mesh import local_rows

# metric dicts drain device -> host in blocks of this many steps
_METRIC_SYNC_STEPS = 16


def _drain_metrics(pending: List[Tuple[float, Dict[str, torch.Tensor]]],
                   agg: Dict[str, float]) -> None:
    """Fetch the queued (weight, device metrics) pairs in one copy to the
    host and fold the count-weighted sums into ``agg``. Clears
    ``pending``."""
    if not pending:
        return
    flat = [v.detach().reshape(()).double() for _, m in pending
            for v in m.values()]
    values = iter(torch.stack(flat).cpu().tolist())
    for w, m in pending:
        for k in m:
            agg[k] = agg.get(k, 0.0) + w * next(values)
    pending.clear()


def run_epoch(dataset, step_fn: Callable, state_or_params, *,
              batch_size: int, weights: Dict[str, Any],
              curriculum: Dict[str, Any], rng_seed: int,
              train: bool, num_workers: int = 4,
              max_batches: Optional[int] = None, device="cuda",
              mesh=None, wire_compact: bool = False,
              wire_skip: tuple = ()):
    """Returns (state_or_params, mean-metrics dict incl. timing).

    ``step_fn`` is ``train_step.make_train_step``'s (``train``) or
    ``make_eval_step``'s function, or their data-parallel forms when
    ``mesh`` has several ranks; ``weights`` / ``curriculum`` are passed to
    it as given (the CLI makes them device scalars once per epoch).
    ``wire_compact`` / ``wire_skip``: the compact wire (module
    docstring)."""
    device = torch.device(device)
    rows = local_rows(batch_size, mesh)     # raises if B % world
    wire = wire_compact and (mesh is None or mesh.world_size == 1)
    put = make_device_put(device, keep_host_keys=())
    if wire:
        def device_put(batch):
            return put(encode_wire_batch(batch, skip=wire_skip))
    else:
        device_put = put
    layout = wire and hasattr(dataset, "set_wire_layout")
    dataset.on_epoch_start()
    n = len(dataset)
    idx_batches = [list(range(i, min(i + batch_size, n)))
                   for i in range(0, n, batch_size)]
    valid_counts = [len(b) for b in idx_batches]
    idx_batches = [b + [b[-1]] * (batch_size - len(b)) for b in idx_batches]
    if max_batches:
        idx_batches = idx_batches[:max_batches]
        valid_counts = valid_counts[:max_batches]

    if layout:
        dataset.set_wire_layout(True)
    loader = PrefetchLoader(
        _Batches(dataset, idx_batches, valid_counts, batch_size, rows),
        iter(range(len(idx_batches))), num_workers=num_workers,
        device_put=device_put)
    try:
        return _run_epoch_loop(loader, step_fn, state_or_params,
                               weights=weights, curriculum=curriculum,
                               rng_seed=rng_seed, train=train,
                               valid_counts=valid_counts, device=device)
    finally:
        loader.close()
        if layout:
            dataset.set_wire_layout(False)


class _Batches:
    """``load_batch(i)``: the dataset's rows ``rows`` of the global batch
    ``idx_batches[i]`` with their slice of its ``__sample_valid__`` mask
    (the first ``valid_counts[i]`` rows are samples, the rest repeats of
    the last)."""

    def __init__(self, dataset, idx_batches: List[List[int]],
                 valid_counts: List[int], batch_size: int, rows: slice):
        self.dataset = dataset
        self.idx_batches = idx_batches
        self.valid_counts = valid_counts
        self.batch_size = batch_size
        self.rows = rows

    def load_batch(self, i) -> Dict[str, np.ndarray]:
        i = int(i)
        batch = self.dataset.load_batch(self.idx_batches[i][self.rows])
        mask = np.zeros((self.batch_size,), bool)
        mask[:self.valid_counts[i]] = True
        batch["__sample_valid__"] = mask[self.rows]
        return batch


def _run_epoch_loop(loader, step_fn, state_or_params, *, weights,
                    curriculum, rng_seed, train, valid_counts, device):
    agg: Dict[str, float] = {}
    pending: list = []  # (weight, on-device metrics) awaiting a block fetch
    n_steps = 0
    n_weight = 0.0
    wait_t = step_t = 0.0
    t0 = time.perf_counter()
    t_wait = time.perf_counter()
    for i, batch in enumerate(loader):
        wait_t += time.perf_counter() - t_wait
        t_step = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(
            rng_seed * 100003 + i)
        if train:
            state_or_params, m = step_fn(state_or_params, batch, gen,
                                         weights, curriculum)
        else:
            m = step_fn(batch, gen, weights, curriculum)
        pending.append((float(valid_counts[i]), m))
        if len(pending) >= _METRIC_SYNC_STEPS:
            _drain_metrics(pending, agg)
        n_steps += 1
        n_weight += float(valid_counts[i])
        step_t += time.perf_counter() - t_step
        t_wait = time.perf_counter()

    _drain_metrics(pending, agg)
    out = {k: v / max(n_weight, 1.0) for k, v in agg.items()}
    out["n_steps"] = n_steps
    out["epoch_time_s"] = time.perf_counter() - t0
    out["wait_s"] = wait_t
    out["step_s"] = step_t
    return state_or_params, out


def train_epoch(dataset, train_step, state, **kw):
    return run_epoch(dataset, train_step, state, train=True, **kw)


def validate_epoch(dataset, eval_step, **kw):
    _, m = run_epoch(dataset, eval_step, None, train=False, **kw)
    return m


__all__ = ["run_epoch", "train_epoch", "validate_epoch"]
