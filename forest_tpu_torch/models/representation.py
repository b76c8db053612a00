"""RepresentationModel: the dual-pathway FRL encoder (z_type / z_phase).

Port of ``forest_tpu/models/representation.py`` (checkpoint schema VERSION
"4"), for inference and training:

- type pathway: Conv2DEncoder (1x1 convs) -> EdgeAwareSmoothingConv2D,
  [B, H, W, C_type] -> z_type [B, H, W, z_type_dim];
- phase pathway: TCNEncoder (pooling 'none') -> Dense bottleneck
  ``phase_head`` -> FiLM(gamma, beta from z_type), either at sampled pixels
  (``forward_phase_at_locations``) or densely (``forward_phase``,
  [B, T, H, W, C_phase] -> [B, T, H, W, z_phase_dim]); in inference on a
  card, a launch of ``ops.tcn_block`` a TCN block, the head and FiLM in the
  last (``_phase``, the one place that picks the path);
- the optional SimCLR projection head on z_type (``project_type``, the
  identity when the config disables it, as the shipped v1 config does).

The type pathway runs in the span ``model.type_encoder``, the phase
pathway (at locations, and so the dense form too) in ``model.phase_encoder``
(``utils.spans``).

Module names follow the flax tree, so ``utils.flax_bridge`` carries
parameters over one to one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from forest_tpu_torch.models.conditioning import FiLMLayer
from forest_tpu_torch.models.conv2d_encoder import (Conv2DEncoder,
                                                    EncoderDraws)
from forest_tpu_torch.models.heads import MLPProjectionHead
from forest_tpu_torch.models.spatial import EdgeAwareSmoothingConv2D
from forest_tpu_torch.models.tcn import TCNEncoder
from forest_tpu_torch.utils.spans import span

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
        with span("model.type_encoder"):
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
        with span("model.phase_encoder"):
            gamma, beta = self.phase_film(z_type_pixels)      # [N, zp]
            z, h = self._phase(x_phase_pixels, gamma, beta,
                               pre_film=return_pre_film,
                               deterministic=deterministic, draws=draws)
        out = (z,)
        if return_film:
            out = out + (gamma, beta)
        if return_pre_film:
            out = out + (h,)
        return out if len(out) > 1 else z

    def forward_phase(self, x_phase: torch.Tensor,
                      z_type: torch.Tensor) -> torch.Tensor:
        """Dense phase forward: [B, T, H, W, C] + [B, H, W, zt] ->
        [B, T, H, W, zp]. On the op's kernel (inference on a card) the
        blocks read x_phase in place and the last writes z_phase, the head
        and FiLM applied, straight into [B, T, H, W, zp]."""
        b, t, h, w, c = x_phase.shape
        with span("model.phase_encoder"):
            gamma, beta = self.phase_film(z_type.reshape(b * h * w, -1))
            return self._phase(x_phase, gamma, beta)[0]

    def _phase(self, x: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, *, pre_film: bool = False,
               deterministic: bool = True,
               draws: Optional[Tuple[torch.Tensor, ...]] = None):
        """The TCN, ``phase_head`` and FiLM on x [N, T, C] or [B, T, H, W,
        C] (N = B H W), with FiLM's gamma and beta [N, zp] -> (z_phase,
        the pre-FiLM h) in x's layout; h is None unless ``pre_film`` (taken
        on [N, T, C] only). The one place that picks the path: in inference
        on a card (``TCNEncoder.takes_kernel``) a launch of ``ops.
        tcn_block`` a block, the head and FiLM in the last, which raises
        for a block no kernel takes; else the modules."""
        tcn = self.phase_tcn
        if tcn.takes_kernel(x, deterministic):
            if not pre_film:
                return tcn.run_kernel(x, self.phase_head, gamma, beta), None
            h = tcn.run_kernel(x, self.phase_head)
            return FiLMLayer.modulate(h, gamma[:, None, :],
                                      beta[:, None, :]), h
        shape = x.shape
        if x.dim() == 5:
            b, t, hh, w, c = shape
            x = x.permute(0, 2, 3, 1, 4).reshape(b * hh * w, t, c)
        h = self.phase_head(tcn(x, deterministic=deterministic,
                                draws=draws))                 # [N, T, zp]
        z = FiLMLayer.modulate(h, gamma[:, None, :], beta[:, None, :])
        if len(shape) == 5:
            z = z.reshape(b, hh, w, t, -1).permute(0, 3, 1, 2, 4)
        return z, (h if pre_film else None)


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
