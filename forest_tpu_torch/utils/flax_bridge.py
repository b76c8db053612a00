"""Map flax parameter trees onto the port's torch state_dicts and back.

The port's modules carry the flax module names (``encoder.conv_0``,
``spatial_conv.mix_backbone``, ``phase_tcn.block_0.conv``, ...), so a flax
path ``a/b/leaf`` becomes the state_dict key ``a.b.<torch leaf>``:

- Conv kernel [kh, kw, I, O] -> Conv2d weight [O, I, kh, kw];
- Conv1d kernel [k, I, O] -> Conv1d weight [O, I, k];
- Dense kernel [I, O] -> Linear weight [O, I];
- GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``; biases as they are.

The Sobel features keep forest_tpu's channel-interleaved layout (gx(c),
gy(c) adjacent), so ``mix_backbone``'s input channels need no permutation.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TO_TORCH = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (flax ``params``) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        arr = np.array(v, np.float32)  # a writable copy
        module, leaf = path.rsplit(".", 1)
        if leaf == "kernel":
            if arr.ndim not in _TO_TORCH:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            arr = arr.transpose(_TO_TORCH[arr.ndim])
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{path}: unknown flax parameter {leaf!r}")
        out[f"{module}.{leaf}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: a 1-D ``weight`` is a GroupNorm
    ``scale``, any other ``weight`` a kernel."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        module, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            elif arr.ndim in _TO_FLAX:
                arr = arr.transpose(_TO_FLAX[arr.ndim])
                leaf = "kernel"
            else:
                raise ValueError(f"{key}: weight of rank {arr.ndim}")
        elif leaf != "bias":
            raise ValueError(f"{key}: unknown parameter {leaf!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


__all__ = ["params_from_flax", "params_to_flax"]
