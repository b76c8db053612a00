# Frozen copy of forest_tpu_torch/eval/export_embeddings.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""The export's dense phase path, plain PyTorch: the port's
``eval/export_embeddings.make_encode_phase_dense``."""
from __future__ import annotations

from typing import Callable

import torch


def make_encode_phase_dense(model, fb, phase_feature: str = "phase_ccdc"
                            ) -> Callable:
    """-> fn(batch, z_type) -> z_phase [B, T, H, W, zp]: the dense phase
    path (``forward_phase``) on the z_type already computed."""

    @torch.inference_mode()
    def encode(batch, z_type):
        px, _ = fb.build_feature(phase_feature, batch)
        return model.forward_phase(px, z_type)

    return encode
