# Frozen copy of forest_tpu_torch/models/conv2d_encoder.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Conv2DEncoder: (conv -> GroupNorm -> ReLU -> channel dropout) x N.

Port of ``forest_tpu/models/conv2d_encoder.py``: bias-free convs, GroupNorm
with eps 1e-5, the activation (ReLU; any other ``activation`` name means
none, as in the JAX module) and dropout on every stage but the last, then,
when ``out_channels`` changes the width, a biased 1x1 projection
``conv_out``. Channel-last NHWC in and out. In training mode
(``deterministic=False``) the raw input goes through a per-sample channel
dropout whose rate is a call argument (a curriculum value), and each stage
but the last through a channel dropout at the module's fixed ``dropout_rate``;
both zero whole [H, W] maps and rescale the kept ones by 1 / (1 - rate).

Randomness: every mask is ``u < 1 - rate`` for a uniform draw ``u`` of shape
[B, 1, 1, C]. The draws come from :class:`EncoderDraws` when given (so a
test can feed another framework's numbers), else from ``generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from gpu_bench.reference.utils.draws import uniform


def fit_groups(requested: int, channels: int) -> int:
    """Largest divisor of ``channels`` that is <= ``requested``."""
    g = max(1, min(requested, channels))
    while channels % g:
        g -= 1
    return g


@dataclass
class EncoderDraws:
    """Uniform [0, 1) draws behind one training forward of the encoder:
    ``input_u`` [B, 1, 1, C_in]; ``layer_u`` one [B, 1, 1, C_i] per stage
    that has dropout (every stage but the last when ``dropout_rate`` > 0)."""
    input_u: torch.Tensor
    layer_u: Tuple[torch.Tensor, ...] = ()


def channel_dropout(x: torch.Tensor, rate, u: torch.Tensor) -> torch.Tensor:
    """Zero whole channel maps of NHWC ``x`` where ``u`` [B, 1, 1, C] is not
    below 1 - rate; kept maps are divided by max(1 - rate, 1e-6)."""
    keep_p = 1.0 - torch.as_tensor(rate, dtype=x.dtype, device=x.device)
    return torch.where(u.to(x.device) < keep_p,
                       x / torch.clamp(keep_p, min=1e-6),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2DEncoder(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_size: int = 1, num_groups: int = 8,
                 dropout_rate: float = 0.0, activation: str = "relu",
                 out_channels: Optional[int] = None):
        super().__init__()
        self.in_channels = in_channels
        self.channels = tuple(channels)
        self.n_layers = len(channels)
        self.dropout_rate = float(dropout_rate)
        self.activation = activation
        c_prev = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"conv_{i}", nn.Conv2d(c_prev, c, kernel_size,
                                                   padding="same",
                                                   bias=False))
            self.add_module(f"norm_{i}", nn.GroupNorm(
                fit_groups(num_groups, c), c, eps=1e-5))
            c_prev = c
        self.conv_out = (nn.Conv2d(c_prev, out_channels, 1)
                         if out_channels is not None
                         and out_channels != c_prev else None)

    def draw(self, batch: int, generator: Optional[torch.Generator],
             device) -> EncoderDraws:
        """All uniform draws of one training forward, from ``generator``."""
        layer_c = self.channels[:-1] if self.dropout_rate > 0.0 else ()
        return EncoderDraws(
            uniform((batch, 1, 1, self.in_channels), generator, device),
            tuple(uniform((batch, 1, 1, c), generator, device)
                  for c in layer_c))

    def forward(self, x: torch.Tensor, *, input_dropout_rate=0.0,
                deterministic: bool = True,
                draws: Optional[EncoderDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, H, W, C_in] -> [B, H, W, C_out] (``out_channels`` when the
        projection is there, else ``channels[-1]``)."""
        if not deterministic:
            if draws is None:
                draws = self.draw(x.shape[0], generator, x.device)
            x = channel_dropout(x, input_dropout_rate, draws.input_u)
        h = x.permute(0, 3, 1, 2)
        for i in range(self.n_layers):
            h = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(h))
            if i < self.n_layers - 1:
                if self.activation == "relu":
                    h = torch.relu(h)
                if self.dropout_rate > 0.0 and not deterministic:
                    h = channel_dropout(
                        h.permute(0, 2, 3, 1), self.dropout_rate,
                        draws.layer_u[i]).permute(0, 3, 1, 2)
        if self.conv_out is not None:
            h = self.conv_out(h)
        return h.permute(0, 2, 3, 1)


__all__ = ["Conv2DEncoder", "EncoderDraws", "channel_dropout", "fit_groups"]
