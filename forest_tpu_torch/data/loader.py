"""Threaded host prefetch pipeline feeding device tensors.

Port of ``forest_tpu/data/loader.py``: blosc decompression releases the GIL,
so a thread pool (no pickling, no process spawn) decodes zarr chunks
concurrently while the main thread keeps the accelerator fed. On a CUDA
device :func:`make_device_put` stages each array in pinned host memory and
copies it with ``non_blocking=True``, so the copy of batch i + 1 overlaps
step i's compute.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from forest_tpu_torch.utils.spans import span


class PrefetchLoader:
    """Iterate ``sampler`` (yielding index arrays), mapping each through
    ``dataset.load_batch`` in a thread pool, with a bounded prefetch queue.

    If ``device_put`` is set (a callable: host batch dict -> device batch),
    it runs on the consumer thread right before yielding, so the H2D copy of
    batch i+1 overlaps step i's compute (CUDA copies and launches are
    asynchronous).

    While a profiler runs, each worker's ``load_batch`` is a
    ``loader.load`` span and each ``device_put`` a ``loader.h2d`` span
    (``utils.spans``).
    """

    def __init__(self, dataset, sampler: Iterable[np.ndarray],
                 num_workers: int = 8, prefetch: int = 4,
                 device_put: Optional[Callable[[Dict], Any]] = None):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = max(1, int(num_workers))
        self.prefetch = max(1, int(prefetch))
        self.device_put = device_put
        self._active: list = []   # (stop, pool, thread) per live iteration
        self._active_lock = threading.Lock()

    def close(self) -> None:
        """Stop the feeder thread and worker pool of every live iteration
        NOW. Escape hatch for consumers that abandon an iterator or hold a
        traceback referencing it: generator finalization otherwise runs
        only at GC, keeping prefetch+num_workers decoded batches pinned
        and the feeder running in the meantime."""
        with self._active_lock:
            active, self._active = self._active, []
        for stop, pool, th in active:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
        for _, _, th in active:
            th.join(timeout=5.0)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _load(self, idx):
        with span("loader.load"):
            return self.dataset.load_batch(idx)

    def __iter__(self) -> Iterator[Any]:
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()
        # Bounded queue of futures: the feeder blocks when enough batches are
        # in flight, capping host memory at prefetch + num_workers batches.
        bounded: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch + self.num_workers)

        def feeder():
            try:
                for idx in self.sampler:
                    if stop.is_set():
                        break
                    fut = pool.submit(self._load, idx)
                    # Bounded put with a stop check so an abandoned
                    # iterator doesn't leave this thread blocked forever.
                    while not stop.is_set():
                        try:
                            bounded.put(fut, timeout=0.25)
                            break
                        except queue.Full:
                            continue
            except BaseException as exc:  # sampler-side failure: surface it
                while not stop.is_set():
                    try:
                        bounded.put(exc, timeout=0.25)
                        break
                    except queue.Full:
                        continue
            finally:
                # The end-of-epoch sentinel MUST be delivered (a dropped
                # sentinel deadlocks the consumer on bounded.get()); retry
                # with the same stop-checked loop as normal puts.
                while True:
                    try:
                        bounded.put(None, timeout=0.25)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        th = threading.Thread(target=feeder, daemon=True)
        entry = (stop, pool, th)
        with self._active_lock:
            self._active.append(entry)
        th.start()
        try:
            while True:
                fut = bounded.get()
                if fut is None:
                    break
                if isinstance(fut, BaseException):
                    raise fut  # sampler raised mid-epoch: don't truncate
                batch = fut.result()
                if self.device_put is not None:
                    with span("loader.h2d"):
                        batch = self.device_put(batch)
                yield batch
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            with self._active_lock:
                if entry in self._active:
                    self._active.remove(entry)


def to_device(array, device) -> "torch.Tensor":
    """One host array, or a CPU tensor (the compact wire's bfloat16 leaves,
    ``data.wire``), -> a tensor on ``device``: through pinned memory and a
    non-blocking copy onto a CUDA device, as it is for the CPU."""
    import torch
    t = array.contiguous() if isinstance(array, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_float64(array, device) -> "torch.Tensor":
    """One host array on ``device`` as float64: copied in its own dtype
    (uint16 and uint32, which torch lacks, as int64) and widened there."""
    import torch
    a = np.ascontiguousarray(array)
    if a.dtype == np.uint16 or a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device).to(torch.float64)


def resolve_device(device) -> "torch.device":
    """The device a CLI runs on: ``cuda`` (the default of every CLI of the
    port) raises where there is no card; nothing falls back to the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                           "device is available (pass --device cpu)")
    return dev


def make_device_put(device="cuda", keep_host_keys=("years",)):
    """Build a device_put callable: every array of a batch (one level of
    nested dicts) goes to ``device``; ``keep_host_keys`` stay numpy."""
    def put(batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            if k in keep_host_keys:  # host keys stay host-side, dict or not
                out[k] = v
            elif isinstance(v, dict):
                out[k] = {n: to_device(a, device) for n, a in v.items()}
            else:
                out[k] = to_device(v, device)
        return out

    return put


__all__ = ["PrefetchLoader", "make_device_put", "to_device",
           "resolve_device"]
