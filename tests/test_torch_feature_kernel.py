"""The feature kernel (``csrc/feature_build.cu``) on a card, against the
composed build (``ops.feature_build.compose``: the PyTorch operations one
channel at a time) on the same card. Every test here is ``cuda``.

Held: every case of ``torch_feature_cases.py`` (transform x preset x mask
kind x whitened or not x full grid or at locations; its data holds NaN,
+-inf, out-of-domain values and zeroed masks), every layout the kernel
reads (strided, broadcast, unbatched, extra leading dims, int32 and
strided coords), group dtypes other than float32, coordinates outside the
grid, the widths the kernel refuses, and the two benchmark cells' builds
at full size (the ``frl_v1`` bindings of ``gpu_bench/configs/frl_v1.json``
with random stats and a random covariance: B 8 full grid, and B 12 full
grid plus the three builds at anchors). Masks must be bit-identical; each build takes one launch,
goes through the kernel (``feature_build.builds``: 100 % for both cells'
bindings) and, its table made, makes no host synchronisation.

Bound on the values, elementwise, in float32 ulps (ulp(1) = 2^-23):
unwhitened |kernel - composed| <= 4 ulp(max(|composed|, 1)): the composed
build on a card divides by a Python scalar as a product with its
reciprocal (ATen's CUDA division by a scalar), the kernel truly, and the
two may call the transcendental functions through other code; whitened
<= 4 (C + 1) ulp(max(sum_c |W_dc xc_c|, 1)), the bound of a C-term dot
product summed in another order (cuBLAS against the kernel's ascending
fused multiply-adds) over inputs already 4 ulps apart.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from forest_tpu_torch.data import parse_bindings
from forest_tpu_torch.data.feature_builder import WHITEN_CLIP, FeatureBuilder
from forest_tpu_torch.ops import feature_build as fbk
from torch_feature_cases import (COORDS, LAYOUTS, MASK_KINDS, PRESETS,
                                 TRANSFORMS, case_batch_np, case_raw,
                                 layout_case, stats_for)
from torch_parity import cuda_device  # noqa: F401

ULP1 = 2.0 ** -23
FRL_V1 = Path(__file__).resolve().parents[1] / "gpu_bench" / "configs" / \
    "frl_v1.json"


def _composed(fb, feature, groups, coords):
    plan = fb._plan(feature)
    gl = [torch.as_tensor(groups[g]) for g in plan.groups]
    _, _, w, mu = fb._table(feature, plan, gl[0].device)
    x, m = fbk.compose(gl, plan.channels, w, mu, plan.temporal, WHITEN_CLIP,
                       coords)
    if w is None:
        return x, m, torch.clamp(x.abs(), min=1.0), 4
    raw, _ = fbk.compose(gl, plan.channels, None, None, plan.temporal,
                         WHITEN_CLIP, coords)
    fin = m & torch.isfinite(raw)
    xc = torch.where(fin, raw - mu, torch.zeros_like(raw))
    terms = torch.einsum("...c,dc->...d", xc.abs(), w.abs())
    return x, m, torch.clamp(terms, min=1.0), 4 * (w.shape[0] + 1)


def _kernel_vs_composed(fb, feature, groups, coords=None):
    """One kernel build against the composed one: one launch, through the
    kernel, masks equal, values within the bound."""
    launches = fbk.feature_build.launches
    builds = dict(fbk.feature_build.builds)
    if coords is None:
        x, m = fb.build_feature(feature, groups)
    else:
        x, m = fb.build_feature_at_locations(feature, groups, coords)
    torch.cuda.synchronize()
    assert fbk.feature_build.launches == launches + 1
    assert fbk.feature_build.builds == dict(builds,
                                            kernel=builds["kernel"] + 1)
    want, want_m, scale, ulps = _composed(fb, feature, groups, coords)
    assert x.shape == want.shape and x.dtype == torch.float32
    assert torch.equal(m, want_m)
    assert torch.equal(torch.isnan(x), torch.isnan(want))
    gap = torch.nan_to_num(x - want).abs()
    worst = float((gap / (ulps * ULP1 * scale)).max())
    assert worst <= 1.0, f"{worst:.2f} of the bound ({ulps} ulps)"
    return x, m


def _case_fb(transform, preset, mask_kind, whiten):
    bindings = parse_bindings(case_raw(transform, preset, mask_kind, whiten))
    return FeatureBuilder(bindings, stats_for(bindings.features["case"],
                                              "case"))


def _on(device, groups):
    return {k: v.to(device) for k, v in groups.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["grid", "locations"])
@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("transform", TRANSFORMS, ids=str)
def test_kernel_matches_composed_on_card(cuda_device, transform, preset,
                                         mask_kind, whiten, where):
    fb = _case_fb(transform, preset, mask_kind, whiten)
    groups = _on(cuda_device, {k: torch.from_numpy(v)
                               for k, v in case_batch_np().items()})
    coords = None if where == "grid" else \
        torch.from_numpy(COORDS).to(cuda_device)
    _kernel_vs_composed(fb, "case", groups, coords)


@pytest.mark.cuda
@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_reads_every_layout_on_card(cuda_device, layout, whiten):
    mask_kind, groups, coords = layout_case(layout)
    fb = _case_fb({"name": "log", "epsilon": 0.25}, "linear_rescale",
                  mask_kind, whiten)
    _kernel_vs_composed(fb, "case", _on(cuda_device, groups),
                        None if coords is None else coords.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [d for d in fbk.DTYPE_CODES
                                   if d != torch.float32], ids=str)
def test_kernel_reads_group_dtypes_on_card(cuda_device, dtype):
    """The value and mask groups in another dtype, read as the composed
    build's ``.float()`` reads them."""
    fb = _case_fb("sqrt", "zscore", "spatial", True)
    groups = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    for k in ("static", "static_mask"):
        v = groups[k]
        if not dtype.is_floating_point:
            v = torch.nan_to_num(v * 3, nan=0.0, posinf=5.0, neginf=-5.0)
            v = v != 0 if dtype == torch.bool else v.round()
        groups[k] = v.to(dtype)
    x, m = _kernel_vs_composed(fb, "case", _on(cuda_device, groups))
    assert m.any() and not m.all()


@pytest.mark.cuda
def test_kernel_marks_rows_outside_the_grid_on_card(cuda_device):
    """A pixel outside the grid gives an invalid row (x 0, mask False), in
    the kernel, in the composed build on the card and on the CPU alike."""
    fb = _case_fb("sqrt", "zscore", "spatial_to_t", True)
    groups = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    coords = torch.from_numpy(COORDS.copy())
    coords[0, 1] = torch.tensor([12, 0])
    coords[1, 3] = torch.tensor([3, -13])
    x, m = _kernel_vs_composed(fb, "case", _on(cuda_device, groups),
                               coords.to(cuda_device))
    assert not m[0, 1].any() and not m[1, 3].any() and m[0, 0].any()
    assert not x[0, 1].any() and not x[1, 3].any()
    want, want_m = fb.build_feature_at_locations("case", groups, coords)
    assert torch.equal(m.cpu(), want_m)


@pytest.mark.cuda
@pytest.mark.parametrize("whiten", [False, True])
def test_kernel_refuses_wider_features_on_card(cuda_device, whiten):
    """A feature wider than the kernel takes raises on a card: no other
    path builds it there."""
    width = (fbk.MAX_WHITENED_CHANNELS if whiten else fbk.MAX_CHANNELS) + 1
    fb, raw = _frl_v1_builder()
    raw["dataset"]["big"] = {"type": "float32", "dim": ["C", "H", "W"],
                             "channels": [{"name": f"c{k}", "source": "v"}
                                          for k in range(width)]}
    raw["features"]["wide"] = {"dim": ["C", "H", "W"], "channels": {
        f"big.c{k}": {"norm": "zscore"} for k in range(width)},
        "covariance": {"calculate": whiten}}
    stats = dict(fb.stats, wide={"__covariance__": {
        "matrix": np.eye(width).tolist()}})
    fb = FeatureBuilder(parse_bindings(raw), stats)
    with pytest.raises(ValueError, match="channels"):
        fb.build_feature("wide", {"big": torch.ones(1, 2, 2, width,
                                                    device=cuda_device)})


def _frl_v1_builder():
    """The benchmark cells' bindings, with random stats and a random SPD
    covariance for each whitened feature (no identity anywhere)."""
    raw = json.loads(FRL_V1.read_text())["bindings"]
    bindings = parse_bindings(raw)
    rng = np.random.default_rng(21)
    stats = {}
    for fname, fc in bindings.features.items():
        stats[fname] = {ref: {"mean": float(rng.normal(0, 0.3)),
                              "sd": float(rng.uniform(0.5, 2.0)),
                              "q25": -0.6, "q50": 0.1, "q75": 0.7,
                              "min": -3.0, "max": 3.0}
                        for ref in fc.channels}
        if fc.covariance.calculate:
            d = len(fc.channels)
            a = rng.normal(size=(d, d))
            stats[fname]["__covariance__"] = {
                "matrix": (a @ a.T / d + np.eye(d)).tolist(),
                "mean": rng.normal(0, 0.2, size=d).tolist()}
    return FeatureBuilder(bindings, stats), raw


def _frl_v1_batch(raw, b, hw, t, gen, device):
    out = {}
    for name, group in raw["dataset"].items():
        timed = "T" in group["dim"]
        shape = ((b, t, hw, hw) if timed else (b, hw, hw)) + \
            (len(group["channels"]),)
        if group["type"] == "uint8":
            out[name] = (torch.rand(shape, generator=gen, device=device)
                         < 0.9).float()
        else:
            x = torch.randn(shape, generator=gen, device=device)
            x[torch.rand(shape, generator=gen, device=device) < 0.01] = \
                float("nan")
            out[name] = x
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["embed_b8", "train_b12"])
def test_cells_builds_go_through_the_kernel_on_card(cuda_device, cell):
    """Each build of the cell's step: one launch, the kernel's hit share
    100 %, no host synchronisation once the tables are made, within the
    bound at full size."""
    fb, raw = _frl_v1_builder()
    gen = torch.Generator(cuda_device).manual_seed(5)
    b = 8 if cell == "embed_b8" else 12
    groups = _frl_v1_batch(raw, b, 256, 15, gen, cuda_device)
    if cell == "embed_b8":
        builds = [("type_encoder_input", None), ("phase_ccdc", None)]
    else:
        anchors = torch.randint(0, 256, (b, 300, 2), generator=gen,
                                device=cuda_device)
        ext = torch.randint(0, 256, (b, 300 * 4 + 512, 2), generator=gen,
                            device=cuda_device)
        builds = [("type_encoder_input", None),
                  ("infonce_type_spectral", anchors),
                  ("phase_ccdc", anchors), ("infonce_type_spectral", ext)]
    for feature, coords in builds:            # the tables made
        _kernel_vs_composed(fb, feature, groups, coords)
    before = dict(fbk.feature_build.builds)
    launches = fbk.feature_build.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for feature, coords in builds:
            if coords is None:
                fb.build_feature(feature, groups)
            else:
                fb.build_feature_at_locations(feature, groups, coords)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fbk.feature_build.launches == launches + len(builds)
    assert fbk.feature_build.builds == dict(
        before, kernel=before["kernel"] + len(builds))


@pytest.mark.cuda
@pytest.mark.parametrize("width,whiten", [(2, True), (13, True), (16, True),
                                          (17, True), (64, True),
                                          (34, False), (96, False)])
def test_kernel_takes_every_width_on_card(cuda_device, width, whiten):
    """Features of ``width`` channels of a wide group, every other one
    masked: whitened in registers up to 16 channels, through shared memory
    above; the widest the kernel takes."""
    fb, raw = _frl_v1_builder()
    raw["dataset"]["big"] = {"type": "float32", "dim": ["C", "H", "W"],
                             "channels": [{"name": f"c{k}", "source": "v"}
                                          for k in range(width)]}
    chans = {f"big.c{k}": {"norm": "zscore", "transform": "cbrt"}
             for k in range(width)}
    for k in range(0, width, 2):
        chans[f"big.c{k}"]["mask"] = "static_mask.dem_mask"
    raw["features"]["wide"] = {"dim": ["C", "H", "W"], "channels": chans,
                               "covariance": {"calculate": whiten}}
    rng = np.random.default_rng(width)
    a = rng.normal(size=(width, width))
    stats = dict(fb.stats, wide={
        ref: {"mean": float(rng.normal()), "sd": 1.5} for ref in chans})
    stats["wide"]["__covariance__"] = {
        "matrix": (a @ a.T / width + np.eye(width)).tolist(),
        "mean": rng.normal(0, 0.2, size=width).tolist()}
    fb = FeatureBuilder(parse_bindings(raw), stats)
    gen = torch.Generator(cuda_device).manual_seed(width)
    groups = _frl_v1_batch(raw, 2, 64, 3, gen, cuda_device)
    _kernel_vs_composed(fb, "wide", groups)
    _kernel_vs_composed(fb, "wide", groups, torch.randint(
        -64, 64, (2, 40, 2), generator=gen, device=cuda_device))
