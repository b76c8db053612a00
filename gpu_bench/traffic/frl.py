# Copied from forest_tpu_torch/data/cube_v2.py (synthetic_feature_stats, synthetic_frl_batch) at 3cfd860c7617988dff336bd92534bbc78565c650, rewritten to draw on the device.
"""Inputs of the FRL cells: the bindings' feature statistics and batches of
the bindings' dataset groups, drawn on the device from a generator.

A batch of B patches of hw² pixels and T steps holds each dataset group of
the bindings, channel-last, with its channels in the bindings' order: a
group with a time axis is [B, T, hw, hw, C], one without [B, hw, hw, C].
A ``uint8`` group is a mask, each entry 1 with probability ``mask_keep``
(``annual_keep`` with a time axis); an ``int16`` group holds one of
``evt_codes``; in a float group a channel named ``ysfc`` is a whole number
in [0, ``ysfc_max``), one with the ``temporal_position`` formula is
t / (T - 1), and every other is standard normal. ``__window__`` is [B, 2]
zeros.
"""
from __future__ import annotations

from typing import Dict

import torch


def feature_stats(bindings: Dict) -> Dict:
    """Handcrafted statistics of every feature of the bindings dict: mean
    0, sd 1, quartiles -0.5 / 0 / 0.5, range [-3, 3], and an identity
    covariance where the feature asks for one."""
    stats: Dict = {}
    for fname, fc in bindings["features"].items():
        stats[fname] = {ref: {"mean": 0.0, "sd": 1.0, "q25": -0.5,
                              "q50": 0.0, "q75": 0.5, "min": -3.0,
                              "max": 3.0} for ref in fc["channels"]}
        cov = fc.get("covariance") or {}
        if cov.get("calculate"):
            d = len(fc["channels"])
            stats[fname]["__covariance__"] = {
                "matrix": [[float(i == j) for j in range(d)]
                           for i in range(d)],
                "mean": [0.0] * d, "n": 100.0,
                "stat_domain": cov.get("stat_domain", "patch")}
    return stats


def batch(gen: torch.Generator, bindings: Dict, b: int, hw: int, t: int,
          traffic: Dict) -> Dict[str, torch.Tensor]:
    """One batch of ``bindings``' dataset groups on the generator's
    device."""
    dev = gen.device
    out: Dict[str, torch.Tensor] = {}
    for name, group in bindings["dataset"].items():
        chans = group["channels"]
        timed = "T" in group["dim"]
        shape = (b, t, hw, hw) if timed else (b, hw, hw)
        if group["type"] == "uint8":
            keep = traffic["annual_keep" if timed else "mask_keep"]
            out[name] = (torch.rand(shape + (len(chans),), generator=gen,
                                    device=dev) < keep).float()
        elif group["type"] == "int16":
            codes = torch.tensor(traffic["evt_codes"], dtype=torch.float32,
                                 device=dev)
            out[name] = codes[torch.randint(
                0, len(codes), shape + (len(chans),), generator=gen,
                device=dev)]
        else:
            x = torch.randn(shape + (len(chans),), generator=gen,
                            device=dev)
            for i, ch in enumerate(chans):
                if ch.get("formula") == "temporal_position":
                    x[..., i] = (torch.arange(t, device=dev) / (t - 1))[
                        None, :, None, None]
                elif ch["name"] == "ysfc":
                    x[..., i] = torch.randint(
                        0, traffic["ysfc_max"], shape, generator=gen,
                        device=dev).float()
            out[name] = x
    out["__window__"] = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    return out
