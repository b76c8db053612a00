"""Map flax parameter trees onto the port's torch state_dicts and back.

The port's modules carry the flax module names (``encoder.conv_0``,
``spatial_conv.mix_backbone``, ``phase_tcn.block_0.conv``, ...), so a flax
path ``a/b/leaf`` becomes the state_dict key ``a.b.<torch leaf>``:

- Conv kernel [kh, kw, I, O] -> Conv2d weight [O, I, kh, kw];
- Conv1d kernel [k, I, O] -> Conv1d weight [O, I, k];
- Dense kernel [I, O] -> Linear weight [O, I];
- GroupNorm and LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``
  (the projection head's ``type_projection/norm``); biases as they are;
- an ``nn.Embed`` table ``embedding`` and the VQ-VAE's bare parameters
  (``time_emb``, ``time_query``, ``codebook``) keep name and layout.

AdamW's moments have the layout of the parameters, so
:func:`adam_state_from_flax` / :func:`adam_state_to_flax` carry optax's
``mu``, ``nu`` and ``count`` over with the same rules.
:func:`vq_stats_from_flax` / :func:`vq_stats_to_flax` carry the EMA
codebook state, and :func:`opt_state_to_flax` / :func:`opt_state_from_flax`
the optimizer state of the FRL and VQ-VAE steps in the layout
``flax.serialization`` gives optax's ``chain(clip_by_global_norm,
adamw(...))`` (with a weight-decay mask for the VQ-VAE).

The Sobel features keep forest_tpu's channel-interleaved layout (gx(c),
gy(c) adjacent), so ``mix_backbone``'s input channels need no permutation.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_TO_TORCH = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}
# leaves that have the same name and layout on both sides
_AS_IS = ("embedding", "time_emb", "time_query", "codebook")


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
        module, _, leaf = path.rpartition(".")
        if leaf in _AS_IS:
            out[path] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
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
    or LayerNorm ``scale``, any other ``weight`` a kernel."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        module, _, leaf = key.rpartition(".")
        if leaf in _AS_IS:
            pass
        elif leaf == "weight":
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
        for part in (module.split(".") if module else ()):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def adam_state_from_flax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                         count) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor], int]:
    """optax ``ScaleByAdamState`` fields (``mu`` / ``nu`` as nested dicts of
    arrays in the parameters' flax layout, ``count``) -> the port's
    (mu, nu, count): moments keyed like the state_dict."""
    return params_from_flax(mu), params_from_flax(nu), int(count)


def adam_state_to_flax(mu: Mapping[str, torch.Tensor],
                       nu: Mapping[str, torch.Tensor], count: int
                       ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """Inverse of :func:`adam_state_from_flax`."""
    return params_to_flax(mu), params_to_flax(nu), int(count)


def vq_stats_from_flax(tree: Mapping[str, Any]):
    """``{"cluster_size", "cluster_sum", "code_usage"}`` of arrays -> the
    port's ``ops.vq.VQStats`` of float32 CPU tensors."""
    from forest_tpu_torch.ops.vq import VQStats
    return VQStats(*(torch.from_numpy(np.array(tree[f], np.float32))
                     for f in VQStats._fields))


def vq_stats_to_flax(stats) -> Dict[str, np.ndarray]:
    """Inverse of :func:`vq_stats_from_flax`."""
    return {f: getattr(stats, f).detach().to("cpu", torch.float32).numpy()
            for f in stats._fields}


def opt_state_to_flax(mu: Mapping[str, torch.Tensor],
                      nu: Mapping[str, torch.Tensor], count: int,
                      scheduled: bool, masked: bool = False
                      ) -> Dict[str, Any]:
    """A step's optimizer state as ``flax.serialization`` lays out optax's
    ``chain(clip_by_global_norm, adamw(...))``: "0" the clipping (no
    state), "1" AdamW = {"0": Adam's count, mu, nu, "1": the weight decay
    (no state; ``{"inner_state": {}}`` when it is ``masked``, as the
    VQ-VAE's is), "2": the learning-rate scaling, which counts steps when
    the rate is a schedule (``scheduled``)}."""
    fmu, fnu, n = adam_state_to_flax(mu, nu, count)
    cnt = np.asarray(n, np.int32)
    return {"0": {}, "1": {
        "0": {"count": cnt, "mu": fmu, "nu": fnu},
        "1": {"inner_state": {}} if masked else {},
        "2": {"count": cnt.copy()} if scheduled else {}}}


def opt_state_from_flax(tree: Mapping[str, Any]):
    """Inverse of :func:`opt_state_to_flax` -> (mu, nu, count)."""
    adam = tree["1"]["0"]
    return adam_state_from_flax(adam["mu"], adam["nu"],
                                np.asarray(adam["count"]))


__all__ = ["params_from_flax", "params_to_flax", "adam_state_from_flax",
           "adam_state_to_flax", "vq_stats_from_flax", "vq_stats_to_flax",
           "opt_state_to_flax", "opt_state_from_flax"]
