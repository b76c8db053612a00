"""The feature builder's cases, shared by the CPU tests (against the JAX
package, tests/test_torch_features.py) and the card's (the kernel against
the composed build, tests/test_torch_feature_kernel.py). Imports nothing
of JAX.

A case builds a three-channel feature ``case`` whose first channel carries
the case's transform and normalisation preset, the others fixed ones, over
a seeded ``synthetic_frl_batch`` (B 2, 12², T 5) with NaN, +-inf,
out-of-domain values and zeroed masks. Mask kinds: none, spatial (a
spatial feature with spatial masks), spatial_to_t (a temporal feature with
a spatial mask broadcast over T, and a temporal one).
"""
import functools
import json
from pathlib import Path

import numpy as np
import torch

from forest_tpu_torch.data.cube_v2 import (synthetic_bindings,
                                           synthetic_frl_batch)

TRANSFORMS = ["none", "identity", "log1p", "log10", "sqrt", "cbrt", "neg",
              {"name": "log", "epsilon": 0.25}]
PRESETS = {
    "zscore": {"type": "zscore"},
    "robust_iqr": {"type": "robust_iqr"},
    "linear_rescale": {"type": "linear_rescale", "in_min": -2.0,
                       "out_min": -1.0, "out_max": 3.0,
                       "clamp": {"enabled": True, "min": -0.5, "max": 2.0}},
    "identity": {"type": "identity"},
    "clamp": {"type": "clamp", "clamp": {"enabled": True, "max": 1.5}},
}
MASK_KINDS = ["none", "spatial", "spatial_to_t"]
PAIRS = [(json.dumps(t_), p) for t_ in TRANSFORMS for p in PRESETS]
# (row, col) per sample; negative ones count from the end, as indexing does
COORDS = np.array([[[0, 0], [5, 5], [2, -1], [3, 1], [-2, 4]],
                   [[1, 2], [4, 0], [0, 5], [5, 3], [2, 2]]], np.int64)
_RNG = np.random.default_rng(11)
# the stats of the feature's three channels, by position
STATS = [{"mean": float(_RNG.normal()), "sd": float(_RNG.uniform(0.5, 2.0)),
          "q25": -0.6, "q50": float(_RNG.normal(0, 0.2)), "q75": 0.7,
          "min": -2.5, "max": 2.5} for _ in range(3)]
_A = _RNG.normal(size=(3, 3))
COVARIANCE = {"matrix": (_A @ _A.T + 3 * np.eye(3)).tolist(),
              "mean": _RNG.normal(size=3).tolist()}
NOWHERE = Path("unused")


def channels(mask_kind, first_refs):
    """The feature's channels: ``first_refs`` {ref: (transform, preset)}
    in first place, then the two fixed ones."""
    temporal = mask_kind == "spatial_to_t"
    first_mask = ("static_mask.dem_mask" if mask_kind != "none" else None)
    chans = {ref: {"norm": f"p_{p}", "transform": tr, "mask": first_mask}
             for ref, (tr, p) in first_refs.items()}
    if temporal:
        chans["annual.nbr"] = {"mask": "annual_mask.ccdc_ok",
                               "norm": "zscore", "transform": "sqrt"}
        chans["annual.tpos"] = {"norm": "identity"}
    else:
        chans["static.slope"] = {"norm": "zscore", "transform": "sqrt"}
        chans["static.mean_ndvi"] = {
            "norm": "robust_iqr",
            "mask": "static_mask.forest" if mask_kind == "spatial" else None}
    return chans, (["C", "T", "H", "W"] if temporal else ["C", "H", "W"])


def case_raw(transform, preset, mask_kind, whiten):
    raw = synthetic_bindings(NOWHERE / "cube.zarr", NOWHERE / "none.json")
    raw["normalization"] = {f"p_{k}": v for k, v in PRESETS.items()}
    first = "annual.ndvi" if mask_kind == "spatial_to_t" \
        else "static.elevation"
    chans, dim = channels(mask_kind, {first: (transform, preset)})
    raw["features"]["case"] = {"dim": dim, "channels": chans,
                               "covariance": {"calculate": whiten}}
    return raw


def stats_for(fc, name):
    refs = list(fc.channels)
    stats = {name: {ref: STATS[max(0, i - len(refs) + 3)]
                    for i, ref in enumerate(refs)}}
    stats[name]["__covariance__"] = COVARIANCE
    return stats


@functools.lru_cache(maxsize=None)
def case_batch_np():
    rng = np.random.default_rng(12)
    batch = synthetic_frl_batch(rng, b=2, hw=12, t=5)
    batch = {k: v.astype(np.float32) for k, v in batch.items()
             if not k.startswith("__")}
    for k in ("static", "annual"):
        v = batch[k]
        v *= 2.0
        v[rng.random(v.shape) < 0.05] = np.nan
        v[rng.random(v.shape) < 0.02] = np.inf
        v[rng.random(v.shape) < 0.02] = -np.inf
        v[..., 0].flat[:3] = [-1.0, 0.0, -0.25]       # domain edges
    batch["static_mask"][1, 3:6, :, 1] = 0.0
    batch["static_mask"][0, :, 2:9, 2] = 0.0
    batch["annual_mask"][0, 2] = 0.0
    return batch


def layout_case(name):
    """-> (mask kind, groups, coords) of a layout the kernel must read."""
    b = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    temporal = name in ("t_contiguous", "t_time_slice", "t_broadcast_mask",
                        "t_unbatched", "t_at", "t_at_strided_coords")
    coords = None
    if name == "channel_slice":       # rows of a wider tensor
        wide = torch.cat([torch.full_like(b["static"][..., :2], 7.0),
                          b["static"]], -1)
        b["static"] = wide[..., 2:]
    elif name == "transposed":        # H and W swapped in storage
        b["static"] = b["static"].transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "extra_lead":        # [2, B, H, W, C]
        b = {k: torch.stack([v, v.flip(0)]) for k, v in b.items()}
    elif name == "dtypes":
        b["static"] = b["static"].bfloat16()
        b["static_mask"] = b["static_mask"].to(torch.uint8)
    elif name == "t_time_slice":      # every other step of a longer series
        b["annual"] = torch.repeat_interleave(b["annual"], 2, 1)[:, ::2]
    elif name == "t_broadcast_mask":  # [B, 1, H, W, 1], over T
        b["annual_mask"] = b["annual_mask"][:, :1]
    elif name == "t_unbatched":
        b = {k: v[1] for k, v in b.items()}
    elif name == "at_int32":
        coords = torch.from_numpy(COORDS).int()
    elif name in ("at", "t_at"):
        coords = torch.from_numpy(COORDS)
    elif name == "t_at_strided_coords":
        coords = torch.from_numpy(COORDS.transpose(2, 0, 1).copy()
                                  ).permute(1, 2, 0)
    return ("spatial_to_t" if temporal else "spatial"), b, coords


LAYOUTS = ["contiguous", "channel_slice", "transposed", "extra_lead",
           "dtypes", "at", "at_int32", "t_contiguous", "t_time_slice",
           "t_broadcast_mask", "t_unbatched", "t_at", "t_at_strided_coords"]


