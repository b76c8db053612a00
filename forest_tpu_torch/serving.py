"""Micro-batched HTTP serving of the frozen FRL encoder on a torch device.

Port of ``forest_tpu/serving.py``, complete in itself: the micro-batcher,
the per-item ``Failure`` marker, the npz wire format, the HTTP front and
``EncoderService`` are all defined here.

- Concurrent requests coalesce in :class:`MicroBatcher`; one dispatcher
  thread runs the model while ``ThreadingHTTPServer`` fans out the HTTP
  handling.
- A dispatch is bucketed by array signature (a malformed or odd-sized
  request fails or runs alone, never with the others), padded to
  ``max_batch`` by repeating the last patch so that the device always sees
  one batch shape, and sliced back out.
- The patch's group arrays go to ``device``, features are built and the
  encoder runs under ``torch.inference_mode()``, and the embeddings come
  back as numpy.
- Request and response payloads are ``.npz`` bytes: the request holds the
  patch's group arrays as ``ForestDatasetV2.get_patch`` produces them; the
  response carries ``z_type`` [H, W, zt] and optionally dense ``z_phase``.

CLI: ``python -m forest_tpu_torch.serving --checkpoint CKPT --bindings
B.yaml --device cuda [--port 8080] [--max-batch 8] [--max-wait-ms 5]
[--warm-patch-size N]``.
"""
from __future__ import annotations

import io
import json
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

class _Request:
    __slots__ = ("payload", "event", "result", "error")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class Failure:
    """Per-item failure marker a ``run_batch`` may return in place of a
    result: only that item's caller sees the exception, the rest of the
    batch completes normally."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class MicroBatcher:
    """Coalesce concurrent single-item requests into one model call.

    ``run_batch(items) -> results`` is invoked from ONE dispatcher thread
    with 1..max_batch items; each blocked caller receives its own result
    (or the batch's exception). ``max_wait_ms`` bounds the extra latency a
    lone request pays waiting for company.
    """

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]],
                 max_batch: int = 8, max_wait_ms: float = 5.0):
        self._run = run_batch
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatch-dispatch")
        self._thread.start()

    def submit(self, payload) -> Any:
        """Block until the coalesced batch containing ``payload`` ran."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        req = _Request(payload)
        self._q.put(req)
        if self._stop.is_set() and not self._thread.is_alive():
            # Raced with close(): the dispatcher is gone and can never
            # serve this request; fail it rather than block forever.
            if not req.event.wait(0.1):
                req.error = RuntimeError("MicroBatcher is closed")
                req.event.set()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                results = self._run([r.payload for r in batch])
                for r, out in zip(batch, results):
                    if isinstance(out, Failure):
                        r.error = out.error
                    else:
                        r.result = out
            except BaseException as e:  # surfaced per caller
                for r in batch:
                    r.error = e
            for r in batch:
                r.event.set()
        # Fail (never strand) requests still queued at close(): their
        # callers are blocked in submit() and must be woken.
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                r.error = RuntimeError("MicroBatcher is closed")
                r.event.set()


class EncoderService:
    """Frozen encoder behind a micro-batching queue, on ``device``.

    ``encode(groups, phase=False)`` takes one patch's group arrays (no batch
    dim) and returns ``{"z_type": [H, W, zt]}`` plus ``"z_phase"``
    [T, H, W, zp] when ``phase=True``. Stacking, padding to ``max_batch``,
    the forward and the slicing happen on the dispatcher thread."""

    def __init__(self, checkpoint: str | Path, bindings: str | Path,
                 device: str | torch.device = "cuda", max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        from forest_tpu_torch.data import parse_bindings
        from forest_tpu_torch.data.feature_builder import FeatureBuilder
        from forest_tpu_torch.eval import frozen

        self.device = torch.device(device)
        self.bindings = parse_bindings(str(bindings))
        self.fb = FeatureBuilder(self.bindings)
        self.model = frozen.load_frozen_model(checkpoint, self.device)
        encode_type, _, _ = frozen.make_encode_fns(self.model, self.fb)
        model, fb = self.model, self.fb

        def to_device(batch: Dict[str, np.ndarray]):
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in batch.items()}

        def enc_t(batch):
            return encode_type(to_device(batch)).float().cpu().numpy()

        @torch.inference_mode()
        def enc_tp(batch):
            groups = to_device(batch)
            x, _ = fb.build_feature("type_encoder_input", groups)
            zt = model(x)
            px, _ = fb.build_feature("phase_ccdc", groups)
            zp = model.forward_phase(px, zt)
            return zt.float().cpu().numpy(), zp.float().cpu().numpy()

        self._enc_t = enc_t
        self._enc_tp = enc_tp
        self.max_batch = int(max_batch)
        self._batcher = MicroBatcher(self._run_batch, max_batch,
                                     max_wait_ms)
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests_served = 0
        self.batches_run = 0

    # -- public API ----------------------------------------------------
    def encode(self, groups: Dict[str, np.ndarray],
               phase: bool = False) -> Dict[str, np.ndarray]:
        return self._batcher.submit((groups, bool(phase)))

    def warmup(self, groups: Dict[str, np.ndarray]) -> None:
        """Run both signatures once for this patch size (builds the kernel,
        lets cuDNN pick its algorithms, fills the allocator)."""
        self.encode(groups, phase=False)
        self.encode(groups, phase=True)

    def close(self) -> None:
        self._batcher.close()

    def stats(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started, 1),
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "max_batch": self.max_batch,
            "z_type_dim": int(self.model.z_type_dim),
            "z_phase_dim": int(self.model.z_phase_dim),
            "device": str(self.device),
        }

    # -- dispatcher side -----------------------------------------------
    @staticmethod
    def _signature(groups) -> tuple:
        """Array signature of a request: (name, shape, dtype) per group."""
        return tuple(sorted(
            (k, np.asarray(v).shape, np.asarray(v).dtype.str)
            for k, v in groups.items()))

    def _run_batch(self, items) -> List[Any]:
        # Concurrent requests may carry different patch sizes (or broken
        # payloads): bucket by array signature so each model call sees
        # ONE shape and a bad request only fails its own caller.
        buckets: Dict[tuple, List[int]] = {}
        out: List[Any] = [None] * len(items)
        for i, (groups, _) in enumerate(items):
            try:
                buckets.setdefault(self._signature(groups), []).append(i)
            except Exception as e:
                out[i] = Failure(e)
        for members in buckets.values():
            try:
                for i, res in zip(members,
                                  self._run_bucket([items[i]
                                                    for i in members])):
                    out[i] = res
            except Exception as e:
                for i in members:
                    out[i] = Failure(e)
        return out

    def _run_bucket(self, items) -> List[Dict[str, np.ndarray]]:
        n = len(items)
        keys = sorted(items[0][0])
        # pad to max_batch by repeating the last patch: the device always
        # sees [max_batch, ...], so cuDNN's algorithm choice and the
        # allocator's blocks are reused from batch to batch
        idx = list(range(n)) + [n - 1] * (self.max_batch - n)
        batch = {k: np.stack([np.asarray(items[i][0][k]) for i in idx])
                 for k in keys}
        want_phase = any(p for _, p in items)
        if want_phase:
            zt, zp = self._enc_tp(batch)
            zt, zp = np.asarray(zt), np.asarray(zp)
        else:
            zt = np.asarray(self._enc_t(batch))
            zp = None
        out = []
        for i, (_, p) in enumerate(items):
            one = {"z_type": zt[i]}
            if p:
                one["z_phase"] = zp[i]
            out.append(one)
        with self._lock:
            self.requests_served += n
            self.batches_run += 1
        return out


# ---------------------------------------------------------------------
# npz wire format
# ---------------------------------------------------------------------
def pack_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: np.asarray(z[k]) for k in z.files}


# ---------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------
def make_server(service: EncoderService, host: str = "127.0.0.1",
                port: int = 8080):
    """ThreadingHTTPServer: POST /v1/encode (npz body, ``?phase=1`` for
    dense phase embeddings) -> npz; GET /healthz -> JSON stats."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._reply(200, json.dumps(service.stats()).encode(),
                            "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            u = urlparse(self.path)
            if u.path != "/v1/encode":
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                groups = unpack_npz(self.rfile.read(length))
                phase = parse_qs(u.query).get("phase", ["0"])[0] in (
                    "1", "true")
                out = service.encode(groups, phase=phase)
                self._reply(200, pack_npz(out), "application/npz")
            except Exception as e:  # per-request failure, server stays up
                self._reply(400, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--bindings", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--warm-patch-size", type=int, default=0,
                    help="before listening, encode one real patch of this "
                         "size from the bindings' cube, with and without "
                         "z_phase (builds the kernel, lets cuDNN pick its "
                         "algorithms, fills the allocator)")
    a = ap.parse_args(argv)
    service = EncoderService(a.checkpoint, a.bindings, device=a.device,
                             max_batch=a.max_batch,
                             max_wait_ms=a.max_wait_ms)
    if a.warm_patch_size:
        from forest_tpu_torch.data.frl_dataset import ForestDatasetV2
        ds = ForestDatasetV2(service.bindings, split=None,
                             patch_size=a.warm_patch_size)
        service.warmup(ds.get_patch(0))
        print(f"warm: ran both signatures at {a.warm_patch_size}px / "
              f"B={a.max_batch}")
    srv = make_server(service, a.host, a.port)
    print(f"serving on http://{a.host}:{a.port} from {service.device}  "
          f"(POST /v1/encode, GET /healthz)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()


__all__ = ["EncoderService", "MicroBatcher", "Failure", "make_server",
           "pack_npz", "unpack_npz"]


if __name__ == "__main__":
    main()
