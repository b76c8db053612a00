# Frozen copy of forest_tpu_torch/models/representation.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""RepresentationModel: the dual-pathway FRL encoder (z_type / z_phase).

Port of ``forest_tpu/models/representation.py`` (checkpoint schema VERSION
"4"), for inference and training:

- type pathway: Conv2DEncoder (1x1 convs) -> EdgeAwareSmoothingConv2D,
  [B, H, W, C_type] -> z_type [B, H, W, z_type_dim];
- phase pathway: TCNEncoder (pooling 'none') -> Dense bottleneck
  ``phase_head`` -> FiLM(gamma, beta from z_type), either at sampled pixels
  (``forward_phase_at_locations``) or densely (``forward_phase``,
  [B, T, H, W, C_phase] -> [B, T, H, W, z_phase_dim]);
- the optional SimCLR projection head on z_type (``project_type``, the
  identity when the config disables it, as the shipped v1 config does).

Module names follow the flax tree, so ``utils.flax_bridge`` carries
parameters over one to one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from gpu_bench.reference.models.conditioning import FiLMLayer
from gpu_bench.reference.models.conv2d_encoder import (Conv2DEncoder,
                                                    EncoderDraws)
from gpu_bench.reference.models.heads import MLPProjectionHead
from gpu_bench.reference.models.spatial import EdgeAwareSmoothingConv2D
from gpu_bench.reference.models.tcn import TCNEncoder

VERSION = "4"


class RepresentationModel(nn.Module):
    def __init__(self, type_in_channels: int, phase_in_channels: int,
                 z_type_dim: int = 48, z_phase_dim: int = 8,
                 type_encoder_channels: Sequence[int] = (128, 48),
                 type_encoder_kernel_size: int = 1,
                 type_encoder_num_groups: int = 8,
                 type_encoder_dropout: float = 0.0,
                 spatial_conv_gate_hidden: int = 64,
                 spatial_conv_gate_kernel_size: int = 3,
                 spatial_conv_num_directions: int = 4,
                 spatial_conv_coarse_dilation: int = 3,
                 spatial_conv_rank: int = 4,
                 spatial_conv_compute_dtype: Optional[str] = None,
                 phase_tcn_channels: Sequence[int] = (64, 64, 64),
                 phase_tcn_kernel_size: int = 3,
                 phase_tcn_dilations: Sequence[int] = (1, 2, 4),
                 phase_tcn_num_groups: int = 8,
                 phase_tcn_dropout: float = 0.0,
                 type_proj_hidden_dim: Optional[int] = None,
                 type_proj_output_dim: Optional[int] = None,
                 type_proj_l2_normalize: bool = True):
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
            num_groups=type_encoder_num_groups,
            dropout_rate=type_encoder_dropout)
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
            num_groups=phase_tcn_num_groups, pooling="none",
            dropout_rate=phase_tcn_dropout)
        self.phase_head = nn.Linear(phase_tcn_channels[-1], z_phase_dim)
        self.phase_film = FiLMLayer(z_type_dim, z_phase_dim)
        self.type_projection = (
            MLPProjectionHead(z_type_dim, type_proj_hidden_dim,
                              type_proj_output_dim, type_proj_l2_normalize)
            if type_proj_hidden_dim is not None
            and type_proj_output_dim is not None else None)

    # --- type pathway ------------------------------------------------------

    def forward(self, x: torch.Tensor, *, return_gate: bool = False,
                input_dropout_rate=0.0, min_gate=0.0,
                deterministic: bool = True,
                draws: Optional[EncoderDraws] = None,
                generator: Optional[torch.Generator] = None):
        """[B, H, W, C_type] -> z_type [B, H, W, z_type_dim] (+ gate).

        ``deterministic=False`` turns the encoder's dropouts on; their
        uniform draws come from ``draws`` or else from ``generator``."""
        h = self.encoder(x, input_dropout_rate=input_dropout_rate,
                         deterministic=deterministic, draws=draws,
                         generator=generator)
        return self.spatial_conv(h, min_gate=min_gate,
                                 return_gate=return_gate)

    def project_type(self, z_type: torch.Tensor) -> torch.Tensor:
        """SimCLR projection of z_type [..., zt]; identity when disabled."""
        if self.type_projection is None:
            return z_type
        return self.type_projection(z_type)

    # --- phase pathway -----------------------------------------------------

    def forward_phase_at_locations(self, x_phase_pixels: torch.Tensor,
                                   z_type_pixels: torch.Tensor, *,
                                   return_film: bool = False,
                                   return_pre_film: bool = False,
                                   deterministic: bool = True,
                                   draws: Optional[Tuple[torch.Tensor,
                                                         ...]] = None):
        """[N, T, C_phase] + [N, z_type_dim] -> z_phase [N, T, z_phase_dim],
        followed by (gamma, beta) [N, zp] with ``return_film`` and the
        pre-FiLM bottleneck h [N, T, zp] with ``return_pre_film``. The
        caller stops the gradient of ``z_type_pixels``. ``deterministic=
        False`` turns the TCN's dropout on, with ``draws`` from
        ``phase_tcn.draw`` (required then)."""
        h = self.phase_head(self.phase_tcn(
            x_phase_pixels, deterministic=deterministic,
            draws=draws))                                     # [N, T, zp]
        gamma, beta = self.phase_film(z_type_pixels)          # [N, zp]
        z = FiLMLayer.modulate(h, gamma[:, None, :], beta[:, None, :])
        out = (z,)
        if return_film:
            out = out + (gamma, beta)
        if return_pre_film:
            out = out + (h,)
        return out if len(out) > 1 else z

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
def init_parameters(model: nn.Module,
                    generator: torch.Generator) -> None:
    """Random weights as flax initialises them: conv / dense kernels
    N(0, 1/fan_in) (LeCun normal, untruncated), zero biases, unit GroupNorm
    and LayerNorm scales; FiLM output layers N(0, 0.01^2) with gamma bias
    1, beta bias 0. The counterpart of the JAX package's
    ``init_variables`` (``forest_tpu/models/representation.py``), which
    initialises every subtree in one pass too, from a ``jax.random`` key:
    a seed here does not give the JAX weights. ``model`` is a
    :class:`RepresentationModel` or any of its blocks.
    ``generator`` is a CPU generator, so a seed gives the same weights on
    every device."""
    film_out = {}
    for film in model.modules():
        if isinstance(film, FiLMLayer):
            film_out.update({film.gamma_1: 1.0, film.beta_1: 0.0})
    for mod in model.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = mod.weight
            std = 0.01 if mod in film_out else (w[0].numel()) ** -0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if mod.bias is not None:
                mod.bias.fill_(film_out.get(mod, 0.0))
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
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
    on = proj.get("enabled", False)
    return RepresentationModel(
        type_in_channels=type_in_channels,
        phase_in_channels=phase_in_channels,
        z_type_dim=m.get("z_type_dim", 48),
        z_phase_dim=m.get("z_phase_dim", 8),
        type_encoder_channels=tuple(t.get("channels", (128, 48))),
        type_encoder_kernel_size=t.get("kernel_size", 1),
        type_encoder_num_groups=t.get("num_groups", 8),
        type_encoder_dropout=t.get("dropout_rate", 0.0),
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
        phase_tcn_dropout=p.get("dropout_rate", 0.0),
        type_proj_hidden_dim=proj.get("hidden_dim") if on else None,
        type_proj_output_dim=proj.get("output_dim") if on else None,
        type_proj_l2_normalize=proj.get("l2_normalize", True),
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
                "dropout_rate": hp["type_encoder_dropout"],
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
                "dropout_rate": hp["phase_tcn_dropout"],
                "num_groups": hp["phase_tcn_num_groups"],
            },
            "type_projection": {
                "enabled": model.type_projection is not None,
                "hidden_dim": hp["type_proj_hidden_dim"],
                "output_dim": hp["type_proj_output_dim"],
                "l2_normalize": hp["type_proj_l2_normalize"],
            },
        },
    }


__all__ = ["RepresentationModel", "from_config", "model_config_dict",
           "init_parameters", "VERSION"]
