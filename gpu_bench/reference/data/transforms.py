# Frozen copy of forest_tpu_torch/data/transforms.py at 3cfd860c7617988dff336bd92534bbc78565c650, its kernels replaced by their plain versions.
"""Pre-normalisation transforms, with their inverses.

Port of ``forest_tpu/data/transforms.py``: the same named transforms (none,
identity, log1p, log10, sqrt, cbrt, neg, and the parameterised ``log`` =
log(x + epsilon)) and the same spec parsing. :func:`get_transform` gives a
:class:`Transform` whose ``forward``, ``inverse`` and ``domain_check`` take
a tensor or a numpy array and answer in kind (the phase probe inverts
float64 numpy columns as well as tensors on the device).
:func:`apply_transform` makes out-of-domain inputs NaN, to be masked
downstream.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

TransformSpec = Union[str, Dict[str, Any], None]

LOG_DEFAULT_EPSILON = 1.0


class Transform(NamedTuple):
    name: str
    forward: Callable
    inverse: Callable
    domain_check: Callable  # x -> bool array (valid input domain)


def parse_transform_spec(spec: TransformSpec
                         ) -> Tuple[Optional[str], Dict[str, Any]]:
    """String / dict / None spec -> (name, params)."""
    if spec is None:
        return None, {}
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, dict):
        d = dict(spec)
        name = d.pop("name", None)
        if name is None:
            raise ValueError("parameterized transform dict must include a "
                             f"'name' key, got {spec}")
        return name, d
    raise TypeError(f"transform spec must be str, dict, or None -- got "
                    f"{type(spec).__name__}")


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def _cbrt(x):
    if isinstance(x, torch.Tensor):   # torch has no cbrt
        return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    return np.cbrt(x)


def _finite(x):
    return _xp(x).isfinite(x)


_REGISTRY: Dict[str, Transform] = {t.name: t for t in (
    Transform("none", lambda x: x, lambda x: x, _finite),
    Transform("identity", lambda x: x, lambda x: x, _finite),
    Transform("log1p", lambda x: _xp(x).log1p(x), lambda x: _xp(x).expm1(x),
              lambda x: _finite(x) & (x > -1)),
    Transform("log10", lambda x: _xp(x).log10(x), lambda x: 10.0 ** x,
              lambda x: _finite(x) & (x > 0)),
    Transform("sqrt", lambda x: _xp(x).sqrt(x), lambda x: x * x,
              lambda x: _finite(x) & (x >= 0)),
    Transform("cbrt", _cbrt, lambda x: x * x * x, _finite),
    Transform("neg", lambda x: -x, lambda x: -x, _finite),
)}


def register(t: Transform) -> None:
    """Add (or replace) a named transform; :func:`get_transform` then
    finds it by name."""
    _REGISTRY[t.name] = t


def get_transform(spec: TransformSpec) -> Transform:
    name, params = parse_transform_spec(spec)
    if name is None:
        return _REGISTRY["none"]
    if name == "log":
        eps = float(params.get("epsilon", LOG_DEFAULT_EPSILON))
        return Transform("log", lambda x: _xp(x).log(x + eps),
                         lambda x: _xp(x).exp(x) - eps,
                         lambda x: _finite(x) & (x > -eps))
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown transform {name!r}; have {sorted(_REGISTRY) + ['log']}")
    if params:
        raise ValueError(f"transform {name!r} takes no parameters, "
                         f"got {params}")
    return _REGISTRY[name]


def apply_transform(spec: TransformSpec, x: torch.Tensor) -> torch.Tensor:
    """Apply the transform; out-of-domain inputs become NaN."""
    t = get_transform(spec)
    ok = t.domain_check(x)
    safe = torch.where(ok, x, torch.ones_like(x))
    return torch.where(ok, t.forward(safe), torch.full_like(x, float("nan")))


__all__ = ["Transform", "TransformSpec", "get_transform", "apply_transform",
           "parse_transform_spec", "register", "LOG_DEFAULT_EPSILON"]
