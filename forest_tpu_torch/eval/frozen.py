"""Frozen-encoder loading and the encode closures of the eval tools.

Port of ``forest_tpu/eval/frozen.py``: a checkpoint written by either
package (flax msgpack + ``.json`` sidecar with ``model_config``,
``type_in_channels`` and ``phase_in_channels``) becomes a
RepresentationModel in eval mode on ``device``, and
:func:`make_encode_fns` gives the closures that serving, the probes,
``embed_locations`` and ``export_embeddings`` call. Every closure runs
under ``torch.inference_mode()`` on the model's device and takes the group
tensors of a batch there (:func:`batch_to_device`).

Where the JAX closures vmap one sample's coords [A, 2] over the batch,
these expand the shared coords to [B, A, 2] and run the batched
``build_feature_at_locations`` / ``extract_at_locations`` once.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from forest_tpu_torch.data.feature_builder import FeatureBuilder
from forest_tpu_torch.data.loader import to_device
from forest_tpu_torch.models import representation as rep
from forest_tpu_torch.training.checkpointing import load_state_raw
from forest_tpu_torch.utils import spatial as sp
from forest_tpu_torch.utils.flax_bridge import params_from_flax


def load_frozen_model(ckpt_path: str | Path, device: str | torch.device
                      ) -> rep.RepresentationModel:
    raw, meta = load_state_raw(Path(ckpt_path))
    model = rep.from_config(meta["model_config"],
                            int(meta["type_in_channels"]),
                            int(meta["phase_in_channels"]))
    model.load_state_dict(params_from_flax(raw["params"]), strict=True)
    return model.to(device).eval()


def batch_to_device(batch: Mapping, device, keep: Optional[set] = None
                    ) -> Dict[str, torch.Tensor]:
    """Host group arrays -> tensors on ``device`` (pinned, non-blocking
    onto a card). Keys starting with ``__`` are dropped, and so is every
    group outside ``keep`` when it is given."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else to_device(v, device))
            for k, v in batch.items()
            if not k.startswith("__") and (keep is None or k in keep)}


def to_host(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device tensors -> numpy arrays of the same shapes in one copy:
    booleans stay booleans, float64 stays float64, the rest is float32."""
    wide = any(t.dtype == torch.float64 for t in tensors.values())
    flat = torch.cat([t.reshape(-1).to(torch.float64 if wide
                                       else torch.float32)
                      for t in tensors.values()]).cpu().numpy()
    out, at = {}, 0
    for k, t in tensors.items():
        a = flat[at:at + t.numel()].reshape(tuple(t.shape))
        out[k] = a.astype(bool if t.dtype == torch.bool else
                          np.float64 if t.dtype == torch.float64 else
                          np.float32)
        at += t.numel()
    return out


def _batch_size(batch: Mapping) -> int:
    return next(v.shape[0] for k, v in batch.items()
                if not k.startswith("__"))


def _per_sample(coords: torch.Tensor, b: int, device) -> torch.Tensor:
    """Shared coords [A, 2] -> [B, A, 2] (int64, on ``device``)."""
    return torch.as_tensor(coords, device=device).long().expand(b, -1, -1)


def _phase_at(model, fb: FeatureBuilder, phase_feature: str, batch,
              z_type: torch.Tensor, coords, return_film: bool = False):
    """z_phase [B, A, T, zp] at coords [A, 2] (and FiLM's gamma [B, A,
    zp])."""
    b = z_type.shape[0]
    cb = _per_sample(coords, b, z_type.device)
    a = cb.shape[1]
    px, _ = fb.build_feature_at_locations(phase_feature, batch, cb)
    zt_a = sp.extract_at_locations(z_type, cb)                # [B, A, zt]
    out = model.forward_phase_at_locations(
        px.reshape(b * a, *px.shape[2:]), zt_a.reshape(b * a, -1),
        return_film=return_film)
    if not return_film:
        return out.reshape(b, a, *out.shape[1:])
    z, gamma, _ = out
    return z.reshape(b, a, *z.shape[1:]), gamma.reshape(b, a, -1)


def make_encode_fns(model: rep.RepresentationModel, fb: FeatureBuilder,
                    type_feature: str = "type_encoder_input",
                    phase_feature: str = "phase_ccdc"
                    ) -> Tuple[Callable, Callable, Callable]:
    """-> (encode_type, encode_phase, project):

    encode_type(batch) -> z_type [B, H, W, zt]
    encode_phase(batch, coords [A, 2]) -> z_phase [B, A, T, zp]
    project(z [N, zt]) -> g [N, gt] (z itself without a projection head)
    """

    @torch.inference_mode()
    def encode_type(batch):
        x, _ = fb.build_feature(type_feature, batch)
        return model(x)

    @torch.inference_mode()
    def encode_phase(batch, coords):
        return _phase_at(model, fb, phase_feature, batch,
                         encode_type(batch), coords)

    @torch.inference_mode()
    def project(z):
        return model.project_type(z)

    return encode_type, encode_phase, project


def make_encode_phase_film(model: rep.RepresentationModel,
                           fb: FeatureBuilder,
                           type_feature: str = "type_encoder_input",
                           phase_feature: str = "phase_ccdc") -> Callable:
    """encode(batch, coords [A, 2]) -> (z_phase [B, A, T, zp], gamma
    [B, A, zp]): the FiLM-diagnostics variant."""
    encode_type, _, _ = make_encode_fns(model, fb, type_feature,
                                        phase_feature)

    @torch.inference_mode()
    def encode(batch, coords):
        return _phase_at(model, fb, phase_feature, batch,
                         encode_type(batch), coords, return_film=True)

    return encode


def make_phase_target_fn(fb: FeatureBuilder, target_feature: str
                         ) -> Callable:
    """encode_phase's companion: targets(batch, coords [A, 2]) -> (the
    target feature at coords, [B, A, T, C] or [B, A, C], and its mask)."""

    @torch.inference_mode()
    def targets(batch, coords):
        any_group = next(v for k, v in batch.items()
                         if not k.startswith("__"))
        cb = _per_sample(coords, _batch_size(batch), any_group.device)
        return fb.build_feature_at_locations(target_feature, batch, cb)

    return targets


def require_patches(ds, split, patch_size, split_block_size) -> None:
    """Exit with an actionable message when a split enumerates no patch: on
    a small cube a coarse checkerboard block size can put every block in
    one split."""
    if len(ds) == 0:
        raise SystemExit(
            f"no patches in split {split!r} (patch_size={patch_size}, "
            f"split_block_size={tuple(split_block_size)}): on small cubes "
            "every checkerboard block may land in one split -- try a smaller "
            "--split-block-size (e.g. 1 1) or --patch-size, or another split")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an eval CLI runs on: ``cuda`` (the default) raises where
    there is no card; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                           "device is available (pass --device cpu)")
    return dev


__all__ = ["load_frozen_model", "make_encode_fns", "make_encode_phase_film",
           "make_phase_target_fn", "require_patches", "batch_to_device",
           "to_host", "resolve_device"]
