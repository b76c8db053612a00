"""Pre-normalisation transforms on tensors.

Port of ``forest_tpu/data/transforms.py``'s ``apply_transform``: the same
named transforms (none, identity, log1p, log10, sqrt, cbrt, neg, and the
parameterised ``log`` = log(x + epsilon)), spec parsing shared with the JAX
package. Out-of-domain inputs become NaN, to be masked downstream.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from forest_tpu.data.transforms import (LOG_DEFAULT_EPSILON, TransformSpec,
                                        parse_transform_spec)

# name -> (forward, domain check)
_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "none": (lambda x: x, torch.isfinite),
    "identity": (lambda x: x, torch.isfinite),
    "log1p": (torch.log1p, lambda x: torch.isfinite(x) & (x > -1)),
    "log10": (torch.log10, lambda x: torch.isfinite(x) & (x > 0)),
    "sqrt": (torch.sqrt, lambda x: torch.isfinite(x) & (x >= 0)),
    # torch has no cbrt: sign(x) * |x|^(1/3), finite everywhere
    "cbrt": (lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
             torch.isfinite),
    "neg": (torch.neg, torch.isfinite),
}


def _get(spec: TransformSpec) -> Tuple[Callable, Callable]:
    name, params = parse_transform_spec(spec)
    if name is None:
        return _REGISTRY["none"]
    if name == "log":
        eps = float(params.get("epsilon", LOG_DEFAULT_EPSILON))
        return (lambda x: torch.log(x + eps),
                lambda x: torch.isfinite(x) & (x > -eps))
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown transform {name!r}; have {sorted(_REGISTRY) + ['log']}")
    if params:
        raise ValueError(f"transform {name!r} takes no parameters, "
                         f"got {params}")
    return _REGISTRY[name]


def apply_transform(spec: TransformSpec, x: torch.Tensor) -> torch.Tensor:
    """Apply the transform; out-of-domain inputs become NaN."""
    forward, domain = _get(spec)
    ok = domain(x)
    safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, forward(safe), torch.full_like(x, float("nan")))


__all__ = ["apply_transform"]
