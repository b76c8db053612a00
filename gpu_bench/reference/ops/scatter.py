# Frozen copy of forest_tpu_torch/ops/scatter.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Row extraction from a [B, H, W, C] grid, plain PyTorch.

The plain version of the port's ``ops/scatter.py``: ``extract_at_coords``
is a gather whose gradient autograd forms (a scatter-add).
"""
from __future__ import annotations

import torch


def extract_rows(grid: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """grid [B, R, C], flat_idx [B, N] -> [B, N, C]."""
    idx = flat_idx.long()[:, :, None].expand(-1, -1, grid.shape[2])
    return torch.take_along_dim(grid, idx, dim=1)


def extract_at_coords(grid: torch.Tensor,
                      coords: torch.Tensor) -> torch.Tensor:
    """grid [B, H, W, C], coords [B, N, 2] (row, col) -> [B, N, C]."""
    b, h, w, c = grid.shape
    flat = coords[..., 0] * w + coords[..., 1]
    return extract_rows(grid.reshape(b, h * w, c), flat)
