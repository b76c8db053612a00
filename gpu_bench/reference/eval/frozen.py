# Frozen copy of forest_tpu_torch/eval/frozen.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""The frozen encoder's type pathway, plain PyTorch: the port's
``eval/frozen.make_encode_fns``'s ``encode_type``."""
from __future__ import annotations

from typing import Callable

import torch

from gpu_bench.reference.data.feature_builder import FeatureBuilder
from gpu_bench.reference.models import representation as rep


def make_encode_type(model: rep.RepresentationModel, fb: FeatureBuilder,
                     type_feature: str = "type_encoder_input") -> Callable:
    """encode_type(batch) -> z_type [B, H, W, zt]"""

    @torch.inference_mode()
    def encode_type(batch):
        x, _ = fb.build_feature(type_feature, batch)
        return model(x)

    return encode_type
