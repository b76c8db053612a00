# Frozen copy of forest_tpu_torch/models/spatial.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""EdgeAwareSmoothingConv2D: directional bank smoothing with an edge gate.

Port of ``forest_tpu/models/spatial.py``: per-channel Sobel gradients feed a
conv backbone that predicts rank-R mixing weights (A softmaxed over the K =
2 * num_directions filters, B over the R slots); the fine/coarse directional
bank and the mixing (:func:`bank_mix`, its plain version here); a residual gate sigmoid(conv(relu(conv(x - smoothed)))),
clamped from below by ``min_gate``, blends: out = smoothed + gate * residual.

``compute_dtype`` (e.g. "bfloat16") casts x and the parameters as flax's
``dtype=`` does; the parameters stay float32 and the output takes x's dtype.
Channel-last NHWC in and out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gpu_bench.reference.ops.smoothing import bank_mix, sobel_grads


def _conv(conv: nn.Conv2d, x: torch.Tensor,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv`` on NCHW ``x`` with its parameters cast to ``dtype``."""
    if dtype is None:
        return conv(x)
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding, conv.dilation, conv.groups)


class EdgeAwareSmoothingConv2D(nn.Module):
    def __init__(self, channels: int, gate_hidden: int = 64,
                 gate_kernel_size: int = 3, num_directions: int = 4,
                 coarse_dilation: int = 3, rank: int = 4,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        c, k = channels, 2 * num_directions
        self.num_directions = num_directions
        self.coarse_dilation = coarse_dilation
        self.rank = rank
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        self.mix_backbone = nn.Conv2d(2 * c, gate_hidden, 3, padding="same")
        self.mix_head_A = nn.Conv2d(gate_hidden, k * rank, 1)
        self.mix_head_B = nn.Conv2d(gate_hidden, c * rank, 1)
        self.gate_0 = nn.Conv2d(c, gate_hidden, gate_kernel_size,
                                padding="same")
        self.gate_1 = nn.Conv2d(gate_hidden, c, gate_kernel_size,
                                padding="same")

    def forward(self, x: torch.Tensor, *, min_gate: float = 0.0,
                return_gate: bool = False):
        """[B, H, W, C] -> [B, H, W, C] (and the gate when asked)."""
        in_dtype = x.dtype
        cdt = self.compute_dtype
        if cdt is not None:
            x = x.to(cdt)
        b, h, w, c = x.shape
        k, r = 2 * self.num_directions, self.rank

        feat = sobel_grads(x).permute(0, 3, 1, 2)  # NCHW, gx/gy interleaved
        feat = torch.relu(_conv(self.mix_backbone, feat, cdt))
        a_w = _conv(self.mix_head_A, feat, cdt).permute(0, 2, 3, 1)
        a_w = torch.softmax(a_w.reshape(b, h, w, k, r), dim=3).contiguous()
        b_w = _conv(self.mix_head_B, feat, cdt).permute(0, 2, 3, 1)
        b_w = torch.softmax(b_w.reshape(b, h, w, c, r), dim=4).contiguous()

        smoothed = bank_mix(x.contiguous(), a_w, b_w,
                            num_directions=self.num_directions,
                            coarse_dilation=self.coarse_dilation)

        residual = x - smoothed
        g = _conv(self.gate_0, residual.permute(0, 3, 1, 2), cdt)
        g = _conv(self.gate_1, torch.relu(g), cdt)
        gate = torch.clamp(torch.sigmoid(g), min=min_gate).permute(0, 2, 3, 1)
        out = (smoothed + gate * residual).to(in_dtype)
        if return_gate:
            return out, gate.to(in_dtype)
        return out


__all__ = ["EdgeAwareSmoothingConv2D"]
