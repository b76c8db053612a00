# Frozen copy of forest_tpu_torch/utils/draws.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Raw random draws from an explicit ``torch.Generator``.

Every random function of the port takes its raw draw (a uniform or integer
tensor) as an optional argument and otherwise makes it here: on the
generator's device (a CPU generator cannot fill a CUDA tensor), then moved
to the device the caller works on. ``generator=None`` uses torch's global
generator of ``device``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def uniform(shape: Sequence[int], generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape`` on ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.rand(tuple(shape), generator=generator,
                      device=gdev).to(device)


def randint(low: int, high: int, shape: Sequence[int],
            generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Integers in [low, high) (int64) of ``shape`` on ``device``."""
    gdev = generator.device if generator is not None else device
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=gdev).to(device)


__all__ = ["uniform", "randint"]
