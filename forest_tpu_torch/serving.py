"""Micro-batched HTTP serving of the frozen FRL encoder on a torch device.

Port of ``forest_tpu/serving.py``'s ``EncoderService``. The micro-batcher,
the per-item ``Failure`` marker, the npz wire format and the HTTP front are
the JAX package's own (they import no JAX), and so is the batching logic
this class inherits: concurrent requests coalesce, are bucketed by array
signature, padded to ``max_batch`` by repeating the last patch, and sliced
back out. Only the model side differs: the patch's group arrays go to
``device``, features are built and the encoder runs under
``torch.inference_mode()``, and the embeddings come back as numpy.

CLI: ``python -m forest_tpu_torch.serving --checkpoint CKPT --bindings
B.yaml --device cuda [--port 8080] [--max-batch 8] [--max-wait-ms 5]
[--warm-patch-size N]``.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from forest_tpu import serving as _jax_serving
from forest_tpu.serving import (Failure, MicroBatcher, make_server, pack_npz,
                                unpack_npz)


class EncoderService(_jax_serving.EncoderService):
    """Frozen encoder behind a micro-batching queue, on ``device``.

    ``encode(groups, phase=False)`` takes one patch's group arrays (no batch
    dim) and returns ``{"z_type": [H, W, zt]}`` plus ``"z_phase"``
    [T, H, W, zp] when ``phase=True``."""

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
        encode_type = frozen.make_encode_fns(self.model, self.fb)
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

    def stats(self):
        return dict(super().stats(), device=str(self.device))


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
        from forest_tpu.data.frl_dataset import ForestDatasetV2
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
