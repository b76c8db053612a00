"""Frozen-encoder loading for inference paths.

Port of ``forest_tpu/eval/frozen.py``: a checkpoint written by the JAX
package (flax msgpack + ``.json`` sidecar with ``model_config``,
``type_in_channels`` and ``phase_in_channels``) becomes a RepresentationModel
in eval mode on ``device``. Of the JAX closures only ``encode_type`` is
ported; ``encode_phase`` at sampled locations and ``project`` wait.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict

import torch

from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.models import representation as rep
from forest_tpu_torch.training.checkpointing import load_state_raw
from forest_tpu_torch.utils.flax_bridge import params_from_flax


def load_frozen_model(ckpt_path: str | Path, device: str | torch.device
                      ) -> rep.RepresentationModel:
    raw, meta = load_state_raw(Path(ckpt_path))
    model = rep.from_config(meta["model_config"],
                            int(meta["type_in_channels"]),
                            int(meta["phase_in_channels"]))
    model.load_state_dict(params_from_flax(raw["params"]), strict=True)
    return model.to(device).eval()


def make_encode_fns(model: rep.RepresentationModel, fb: FeatureBuilder,
                    type_feature: str = "type_encoder_input"
                    ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """-> encode_type(batch) -> z_type [B, H, W, zt], batch being group
    tensors on the model's device."""

    @torch.inference_mode()
    def encode_type(batch):
        x, _ = fb.build_feature(type_feature, batch)
        return model(x)

    return encode_type


__all__ = ["load_frozen_model", "make_encode_fns"]
