"""RepresentationModel: the dual-pathway FRL encoder (z_type / z_phase).

Port of ``forest_tpu/models/representation.py`` (checkpoint schema VERSION
"4") for inference:

- type pathway: Conv2DEncoder (1x1 convs) -> EdgeAwareSmoothingConv2D,
  [B, H, W, C_type] -> z_type [B, H, W, z_type_dim];
- phase pathway: TCNEncoder (pooling 'none') -> Dense bottleneck
  ``phase_head`` -> FiLM(gamma, beta from z_type), either at sampled pixels
  (``forward_phase_at_locations``) or densely (``forward_phase``,
  [B, T, H, W, C_phase] -> [B, T, H, W, z_phase_dim]).

The optional projection head is not ported: the shipped v1 config disables
it and serving never calls it, so a config that enables it is refused.
Module names follow the flax tree, so ``utils.flax_bridge`` carries
parameters over one to one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from forest_tpu_torch.models.conditioning import FiLMLayer
from forest_tpu_torch.models.conv2d_encoder import Conv2DEncoder
from forest_tpu_torch.models.spatial import EdgeAwareSmoothingConv2D
from forest_tpu_torch.models.tcn import TCNEncoder

VERSION = "4"


class RepresentationModel(nn.Module):
    def __init__(self, type_in_channels: int, phase_in_channels: int,
                 z_type_dim: int = 48, z_phase_dim: int = 8,
                 type_encoder_channels: Sequence[int] = (128, 48),
                 type_encoder_kernel_size: int = 1,
                 type_encoder_num_groups: int = 8,
                 spatial_conv_gate_hidden: int = 64,
                 spatial_conv_gate_kernel_size: int = 3,
                 spatial_conv_num_directions: int = 4,
                 spatial_conv_coarse_dilation: int = 3,
                 spatial_conv_rank: int = 4,
                 spatial_conv_compute_dtype: Optional[str] = None,
                 phase_tcn_channels: Sequence[int] = (64, 64, 64),
                 phase_tcn_kernel_size: int = 3,
                 phase_tcn_dilations: Sequence[int] = (1, 2, 4),
                 phase_tcn_num_groups: int = 8):
        super().__init__()
        # constructor arguments, read back by model_config_dict
        self.hparams = {k: v for k, v in locals().items()
                        if k not in ("self", "__class__")}
        if type_encoder_channels[-1] != z_type_dim:
            raise ValueError("last type-encoder channel must equal "
                             "z_type_dim")
        self.type_in_channels = type_in_channels
        self.phase_in_channels = phase_in_channels
        self.z_type_dim = z_type_dim
        self.z_phase_dim = z_phase_dim
        self.encoder = Conv2DEncoder(
            type_in_channels, tuple(type_encoder_channels),
            kernel_size=type_encoder_kernel_size,
            num_groups=type_encoder_num_groups)
        self.spatial_conv = EdgeAwareSmoothingConv2D(
            z_type_dim, gate_hidden=spatial_conv_gate_hidden,
            gate_kernel_size=spatial_conv_gate_kernel_size,
            num_directions=spatial_conv_num_directions,
            coarse_dilation=spatial_conv_coarse_dilation,
            rank=spatial_conv_rank,
            compute_dtype=spatial_conv_compute_dtype)
        self.phase_tcn = TCNEncoder(
            phase_in_channels, tuple(phase_tcn_channels),
            kernel_size=phase_tcn_kernel_size,
            dilations=tuple(phase_tcn_dilations),
            num_groups=phase_tcn_num_groups, pooling="none")
        self.phase_head = nn.Linear(phase_tcn_channels[-1], z_phase_dim)
        self.phase_film = FiLMLayer(z_type_dim, z_phase_dim)

    # --- type pathway ------------------------------------------------------

    def forward(self, x: torch.Tensor, *, return_gate: bool = False,
                min_gate: float = 0.0):
        """[B, H, W, C_type] -> z_type [B, H, W, z_type_dim] (+ gate)."""
        return self.spatial_conv(self.encoder(x), min_gate=min_gate,
                                 return_gate=return_gate)

    # --- phase pathway -----------------------------------------------------

    def forward_phase_at_locations(self, x_phase_pixels: torch.Tensor,
                                   z_type_pixels: torch.Tensor
                                   ) -> torch.Tensor:
        """[N, T, C_phase] + [N, z_type_dim] -> z_phase [N, T, z_phase_dim]."""
        h = self.phase_head(self.phase_tcn(x_phase_pixels))  # [N, T, zp]
        gamma, beta = self.phase_film(z_type_pixels)          # [N, zp]
        return FiLMLayer.modulate(h, gamma[:, None, :], beta[:, None, :])

    def forward_phase(self, x_phase: torch.Tensor,
                      z_type: torch.Tensor) -> torch.Tensor:
        """Dense phase forward: [B, T, H, W, C] + [B, H, W, zt] ->
        [B, T, H, W, zp]."""
        b, t, h, w, c = x_phase.shape
        flat = x_phase.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        zt = z_type.reshape(b * h * w, -1)
        z = self.forward_phase_at_locations(flat, zt)
        return z.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)


@torch.no_grad()
def init_parameters(model: RepresentationModel,
                    generator: torch.Generator) -> None:
    """Random weights as flax initialises them: conv / dense kernels
    N(0, 1/fan_in) (LeCun normal, untruncated), zero biases, unit GroupNorm
    scales; FiLM output layers N(0, 0.01^2) with gamma bias 1, beta bias 0.
    ``generator`` is a CPU generator, so a seed gives the same weights on
    every device."""
    film_out = {model.phase_film.gamma_1: 1.0, model.phase_film.beta_1: 0.0}
    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = mod.weight
            std = 0.01 if mod in film_out else (w[0].numel()) ** -0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if mod.bias is not None:
                mod.bias.fill_(film_out.get(mod, 0.0))
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)


# ---------------------------------------------------------------------------
# Config helpers (the JAX package's versioned schema)
# ---------------------------------------------------------------------------


def from_config(cfg: Dict[str, Any], type_in_channels: int,
                phase_in_channels: int) -> RepresentationModel:
    version = str(cfg.get("version", VERSION))
    if version != VERSION:
        raise ValueError(
            f"model config version {version!r} != supported {VERSION!r}")
    m = cfg.get("model", cfg)
    t = m.get("type_encoder", {})
    s = m.get("spatial_conv", {})
    p = m.get("phase_tcn", {})
    proj = m.get("type_projection", {}) or {}
    if proj.get("enabled", False):
        raise NotImplementedError("the type projection head is not ported")
    return RepresentationModel(
        type_in_channels=type_in_channels,
        phase_in_channels=phase_in_channels,
        z_type_dim=m.get("z_type_dim", 48),
        z_phase_dim=m.get("z_phase_dim", 8),
        type_encoder_channels=tuple(t.get("channels", (128, 48))),
        type_encoder_kernel_size=t.get("kernel_size", 1),
        type_encoder_num_groups=t.get("num_groups", 8),
        spatial_conv_gate_hidden=s.get("gate_hidden", 64),
        spatial_conv_gate_kernel_size=s.get("gate_kernel_size", 3),
        spatial_conv_num_directions=s.get("num_directions", 4),
        spatial_conv_coarse_dilation=s.get("coarse_dilation", 3),
        spatial_conv_rank=s.get("rank", 4),
        spatial_conv_compute_dtype=s.get("compute_dtype"),
        phase_tcn_channels=tuple(p.get("channels", (64, 64, 64))),
        phase_tcn_kernel_size=p.get("kernel_size", 3),
        phase_tcn_dilations=tuple(p.get("dilations", (1, 2, 4))),
        phase_tcn_num_groups=p.get("num_groups", 8),
    )


def model_config_dict(model: RepresentationModel) -> Dict[str, Any]:
    """The versioned config dict that :func:`from_config` reads back (the
    layout the JAX package writes into checkpoint metadata)."""
    hp = model.hparams
    return {
        "version": VERSION,
        "model": {
            "z_type_dim": hp["z_type_dim"],
            "z_phase_dim": hp["z_phase_dim"],
            "type_encoder": {
                "channels": list(hp["type_encoder_channels"]),
                "kernel_size": hp["type_encoder_kernel_size"],
                "dropout_rate": 0.0,
                "num_groups": hp["type_encoder_num_groups"],
            },
            "spatial_conv": {
                "gate_hidden": hp["spatial_conv_gate_hidden"],
                "gate_kernel_size": hp["spatial_conv_gate_kernel_size"],
                "num_directions": hp["spatial_conv_num_directions"],
                "coarse_dilation": hp["spatial_conv_coarse_dilation"],
                "rank": hp["spatial_conv_rank"],
                "compute_dtype": hp["spatial_conv_compute_dtype"],
            },
            "phase_tcn": {
                "channels": list(hp["phase_tcn_channels"]),
                "kernel_size": hp["phase_tcn_kernel_size"],
                "dilations": list(hp["phase_tcn_dilations"]),
                "dropout_rate": 0.0,
                "num_groups": hp["phase_tcn_num_groups"],
            },
            "type_projection": {
                "enabled": False,
                "hidden_dim": None,
                "output_dim": None,
                "l2_normalize": True,
            },
        },
    }


__all__ = ["RepresentationModel", "from_config", "model_config_dict",
           "init_parameters", "VERSION"]
