"""forest_tpu_torch feature assembly against forest_tpu's.

``FeatureBuilder.build_feature`` on a seeded ``synthetic_frl_batch`` with
injected NaNs and zeroed masks, for the spatial ``type_encoder_input`` and
the temporal ``phase_ccdc`` (spatial -> temporal mask broadcast), both with
Mahalanobis whitening under a random SPD covariance, and with log / sqrt
pre-transforms on some channels. Transforms and whitening are also held to
the JAX functions one by one. The op ``forest_tpu_torch::feature_build``
(on the CPU its plain version) is held to the JAX builder case by case
(transform x preset x mask kind x whitened or not x full grid or at
locations; ``torch_feature_cases.py``), and the arguments its wrapper hands
the CUDA kernel to a numpy model of the kernel's addressing, on every
layout the kernel takes.

Tolerance: float32 rtol 1e-5 / atol 1e-5 (whitening is a C x C matmul,
summed in another order); masks must be equal.
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.data import transforms as jtr
from forest_tpu.data.bindings import parse_bindings
from forest_tpu.data.cube_v2 import (synthetic_bindings,
                                     synthetic_feature_stats,
                                     synthetic_frl_batch)
from forest_tpu.data.feature_builder import FeatureBuilder as JFB
from forest_tpu.ops import whitening as jwh
from forest_tpu_torch.data import transforms as ttr
from forest_tpu_torch.ops import feature_build as fbk
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.ops import whitening as twh
from forest_tpu_torch.data import parse_bindings as tparse_bindings
from torch_feature_cases import (COORDS, COVARIANCE, LAYOUTS, MASK_KINDS,
                                 NOWHERE, PAIRS, PRESETS, TRANSFORMS,
                                 case_batch_np, case_raw, channels, layout_case,
                                 stats_for)
from torch_parity import t

F32 = dict(rtol=1e-5, atol=1e-5)


def _bindings(tmp_path, parse=parse_bindings):
    raw = synthetic_bindings(tmp_path / "cube.zarr", tmp_path / "none.json")
    chans = raw["features"]["type_encoder_input"]["channels"]
    chans["static.slope"]["transform"] = {"name": "log", "epsilon": 0.5}
    chans["static.variance_ndvi"]["transform"] = "sqrt"
    raw["features"]["type_encoder_input"]["covariance"] = {
        "calculate": True}
    return parse(raw)


def _stats(bindings, seed):
    rng = np.random.default_rng(seed)
    stats = synthetic_feature_stats(bindings)
    for fname, fc in bindings.features.items():
        for ref in fc.channels:
            stats[fname][ref].update(mean=float(rng.normal()),
                                     sd=float(rng.uniform(0.5, 2.0)))
        if fc.covariance.calculate:
            d = len(fc.channels)
            a = rng.normal(size=(d, d))
            stats[fname]["__covariance__"]["matrix"] = \
                (a @ a.T + d * np.eye(d)).tolist()
            stats[fname]["__covariance__"]["mean"] = \
                rng.normal(size=d).tolist()
    return stats


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = synthetic_frl_batch(rng, b=2, hw=12, t=5)
    static, annual = batch["static"], batch["annual"]
    static[rng.random(static.shape) < 0.05] = np.nan
    annual[rng.random(annual.shape) < 0.05] = np.nan
    static[..., 3] = np.abs(static[..., 3])
    static[0, :2, :, 3] = -1.0       # out of sqrt's domain -> masked
    batch["static_mask"][1, 3:6, :, 1] = 0.0
    batch["annual_mask"][0, 2] = 0.0
    return batch


@pytest.mark.parametrize("feature", ["type_encoder_input", "phase_ccdc",
                                     "infonce_type_spectral"])
def test_build_feature_matches_jax(tmp_path, feature):
    bindings = _bindings(tmp_path)
    stats = _stats(bindings, 1)
    batch = _batch(2)
    x_ref, m_ref = JFB(bindings, stats).build_feature(
        feature, {k: jnp.asarray(v) for k, v in batch.items()})
    x, m = TFB(_bindings(tmp_path, tparse_bindings), stats).build_feature(
        feature, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert x.shape == x_ref.shape and x.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    assert not np.all(np.asarray(m_ref))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), **F32)


@pytest.mark.parametrize("spec", [None, "none", "identity", "log1p", "log10",
                                  "sqrt", "cbrt", "neg",
                                  {"name": "log", "epsilon": 0.001}, "log"])
def test_apply_transform_matches_jax(spec):
    x = np.random.default_rng(3).normal(scale=2.0, size=(50,)).astype(
        np.float32)
    x[:3] = [np.nan, np.inf, -1.0]
    ref = np.asarray(jtr.apply_transform(spec, jnp.asarray(x)))
    out = ttr.apply_transform(spec, t(x)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], **F32)


def test_apply_transform_rejects_bad_specs():
    with pytest.raises(KeyError):
        ttr.apply_transform("nope", torch.zeros(2))
    with pytest.raises(ValueError):
        ttr.apply_transform({"name": "sqrt", "epsilon": 1.0}, torch.zeros(2))


def test_whitening_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(3, 3))
    cov = a @ a.T + np.eye(3)
    w = jwh.whitening_matrix(cov)
    np.testing.assert_array_equal(twh.whitening_matrix(cov), w)
    x = rng.normal(scale=3.0, size=(4, 5, 3)).astype(np.float32)
    x[0, 0, 1] = np.nan
    mask = (rng.random((4, 5, 3)) > 0.2).astype(np.float32)
    mean = rng.normal(size=3).astype(np.float32)
    ref = jwh.apply_whitening(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(mean), jnp.asarray(mask), clip=2.0)
    out = twh.apply_whitening(t(x), t(w), t(mean), t(mask), clip=2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


# ------------------------------------------- the op, case by case (CPU)
# Each case builds a three-channel feature whose first channel carries the
# case's transform and normalisation preset, the others fixed ones, with
# NaN, +-inf, out-of-domain values and zeroed masks in the data. The op's
# plain version is held to the JAX FeatureBuilder: to one JAX build per
# mask kind of a wide feature holding every (transform, preset) pair as a
# channel of its own beside the two fixed ones, then, for a whitened case,
# the JAX whitening of the case's three columns, as the JAX builder
# whitens its stack; at locations, to that indexed there (the contract of
# build_feature_at_locations).

@functools.lru_cache(maxsize=None)
def _jax_wide(mask_kind):
    """The JAX build of every (transform, preset) pair at once, pair k
    reading a group ``wk`` of one channel, a copy of the first channel's
    data (one channel a group: JAX compiles a channel's slice once for
    all)."""
    temporal = mask_kind == "spatial_to_t"
    raw = synthetic_bindings(NOWHERE / "cube.zarr", NOWHERE / "none.json")
    raw["normalization"] = {f"p_{k}": v for k, v in PRESETS.items()}
    for k in range(len(PAIRS)):
        raw["dataset"][f"w{k}"] = {
            "type": "float32", "dim": ["C", "T", "H", "W"] if temporal
            else ["C", "H", "W"], "channels": [{"name": "v", "source": "v"}]}
    chans, dim = channels(mask_kind, {
        f"w{k}.v": (json.loads(tr), p) for k, (tr, p) in enumerate(PAIRS)})
    raw["features"]["wide"] = {"dim": dim, "channels": chans}
    bindings = parse_bindings(raw)
    batch = {k: jnp.asarray(v) for k, v in case_batch_np().items()}
    src = batch["annual"][..., :1] if temporal else batch["static"][..., :1]
    batch.update({f"w{k}": src for k in range(len(PAIRS))})
    x, m = JFB(bindings, stats_for(bindings.features["wide"], "wide")
               ).build_feature("wide", batch)
    return np.asarray(x), np.asarray(m)


@functools.lru_cache(maxsize=None)
def _jax_case(transform, preset, mask_kind, whiten):
    x, m = _jax_wide(mask_kind)
    cols = [PAIRS.index((transform, preset)), len(PAIRS), len(PAIRS) + 1]
    x, m = x[..., cols], m[..., cols]
    if whiten:
        w = jwh.whitening_matrix(np.asarray(COVARIANCE["matrix"]), 1e-6)
        x = np.asarray(jwh.apply_whitening(
            jnp.asarray(x), jnp.asarray(w),
            jnp.asarray(np.asarray(COVARIANCE["mean"], np.float32)),
            jnp.asarray(m), clip=5.0))
    return x, m


@pytest.mark.parametrize("where", ["grid", "locations"])
@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("transform", TRANSFORMS, ids=str)
def test_op_matches_jax_case(transform, preset, mask_kind, whiten, where):
    bindings = tparse_bindings(case_raw(transform, preset, mask_kind,
                                         whiten))
    fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
    batch = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    x_ref, m_ref = _jax_case(json.dumps(transform), preset, mask_kind,
                             whiten)
    before = fbk.feature_build.builds["kernel"]
    if where == "grid":
        x, m = fb.build_feature("case", batch)
    else:
        x, m = fb.build_feature_at_locations("case", batch,
                                             torch.from_numpy(COORDS))
        b = np.arange(2)[:, None]
        rows, cols = COORDS[..., 0], COORDS[..., 1]
        if mask_kind == "spatial_to_t":
            x_ref = x_ref.transpose(0, 2, 3, 1, 4)[b, rows, cols]
            m_ref = m_ref.transpose(0, 2, 3, 1, 4)[b, rows, cols]
        else:
            x_ref, m_ref = x_ref[b, rows, cols], m_ref[b, rows, cols]
    assert fbk.feature_build.builds["kernel"] == before + 1
    assert x.shape == x_ref.shape and x.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), m_ref)
    assert m_ref.any() and not m_ref.all()
    np.testing.assert_allclose(x.numpy(), x_ref, **F32)


# ----------------------------- the kernel's arguments, read back (CPU)
# The CUDA kernel runs only on a card; its addressing is held here: the
# arguments the wrapper would hand it (fbk.kernel_args) are read back by a
# numpy model of the kernel's loop (_kernel_model), every (row, channel)
# read where the strides, coords and table say, then the module's
# arithmetic. It must give the plain version's outputs on every layout
# the kernel takes, and those must not depend on the layout.
def _flat(t_):
    """``t_``'s whole storage as one dim of its dtype."""
    n = t_.untyped_storage().nbytes() // t_.element_size()
    return torch.as_strided(t_, (n,), (1,), 0)


def _kernel_model(a, groups, itab, ftab, w, mu, coords, shape):
    rem = np.arange(a.rows)
    q = [None] * a.ndim
    for d in reversed(range(a.ndim)):
        q[d], rem = rem % a.size[d], rem // a.size[d]
    y = xx = np.zeros(a.rows, np.int64)
    ok = np.ones(a.rows, bool)
    if a.coords:
        base = (a.coords - coords.untyped_storage().data_ptr()) \
            // coords.element_size()
        off = base + sum(q[d] * a.cstride[d] for d in range(a.ndim))
        cf = _flat(coords).numpy().astype(np.int64)
        y, xx = cf[off], cf[off + a.cstride_last]
        y, xx = np.where(y < 0, y + a.h, y), np.where(xx < 0, xx + a.w, xx)
        ok = (y >= 0) & (y < a.h) & (xx >= 0) & (xx < a.w)
        y, xx = np.where(ok, y, 0), np.where(ok, xx, 0)

    def read(slot, ch):
        g, ag = groups[slot], a.group[slot]
        assert ag.dtype == fbk.DTYPE_CODES[g.dtype]
        base = (ag.ptr - g.untyped_storage().data_ptr()) // g.element_size()
        off = (base + sum(q[d] * ag.stride[d] for d in range(a.ndim))
               + y * ag.sh + xx * ag.sw + ch * ag.sc)
        return _flat(g)[torch.from_numpy(off)].float()

    assert (a.itab, a.ftab) == (itab.data_ptr(), ftab.data_ptr())
    assert a.wmat == (None if w is None else w.data_ptr())
    chans, masks = [], []
    for ch in fbk.channels_of(itab, ftab):
        v = read(*ch.value)
        valid = torch.isfinite(v) & torch.from_numpy(ok)
        if ch.mask is not None:
            valid = valid & (read(*ch.mask) > 0)
        if ch.transform:
            v = ttr.apply_transform(ch.transform, v)
            valid = valid & torch.isfinite(v)
        zero = torch.zeros_like(v)
        chans.append(torch.where(valid, fbk.normalize(
            torch.where(valid, v, zero), ch.norm), zero))
        masks.append(valid)
    x, m = torch.stack(chans, -1), torch.stack(masks, -1)
    if w is not None:
        x = twh.apply_whitening(x, w, mu, m, clip=a.clip)
    return x.reshape(shape), m.reshape(shape)


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_arguments_read_every_layout(layout, whiten):
    mask_kind, groups, coords = layout_case(layout)
    bindings = tparse_bindings(case_raw({"name": "log", "epsilon": 0.25},
                                         "linear_rescale", mask_kind,
                                         whiten))
    fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
    plan = fb._plan("case")
    gl = [groups[g] for g in plan.groups]
    itab, ftab, w, mu = fb._table("case", plan, gl[0].device)
    x, m = fbk.feature_build(gl, itab, ftab, w, mu, coords, plan.temporal,
                             5.0)
    a, x0, _ = fbk.kernel_args(gl, itab, ftab, w, mu, coords,
                               plan.temporal, 5.0)
    # contiguous groups merge into one row dim; a spatial mask over T
    # keeps B, T and the pixels apart
    assert a.ndim == {"contiguous": 1, "dtypes": 1, "extra_lead": 1,
                      "t_contiguous": 3}.get(layout, a.ndim)
    got = _kernel_model(a, gl, itab, ftab, w, mu, coords, x0.shape)
    np.testing.assert_array_equal(got[1].numpy(), m.numpy())
    np.testing.assert_allclose(got[0].numpy(), x.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the same data, contiguous (a broadcast mask materialised): the same
    # outputs, bit for bit
    dense = {k: v.contiguous() for k, v in groups.items()}
    if layout == "t_broadcast_mask":
        dense["annual_mask"] = groups["annual_mask"].expand(
            -1, groups["annual"].shape[1], -1, -1, -1).contiguous()
    want = fbk.feature_build(
        [dense[g] for g in plan.groups], itab, ftab, w, mu,
        None if coords is None else coords.contiguous().long(),
        plan.temporal, 5.0)
    assert torch.equal(m, want[1])
    np.testing.assert_array_equal(x.numpy(), want[0].numpy())


def test_kernel_arguments_mark_rows_outside_the_grid():
    """A coordinate outside the grid: the kernel makes its row invalid
    (x 0, mask False) and reads nothing there; the op's plain version
    gives the same rows, as it gives every other."""
    mask_kind, groups, _ = layout_case("t_at")
    bindings = tparse_bindings(case_raw("sqrt", "zscore", mask_kind, True))
    fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
    plan = fb._plan("case")
    gl = [groups[g] for g in plan.groups]
    itab, ftab, w, mu = fb._table("case", plan, gl[0].device)
    coords = torch.from_numpy(COORDS.copy())
    coords[0, 1] = torch.tensor([12, 0])
    coords[1, 3] = torch.tensor([3, -13])
    a, x0, _ = fbk.kernel_args(gl, itab, ftab, w, mu, coords, True, 5.0)
    x, m = _kernel_model(a, gl, itab, ftab, w, mu, coords, x0.shape)
    assert not m[0, 1].any() and not m[1, 3].any() and m[0, 0].any()
    assert not x[0, 1].any() and not x[1, 3].any()
    got_x, got_m = fb.build_feature_at_locations("case", groups, coords)
    assert torch.equal(got_m, m)
    np.testing.assert_allclose(got_x.numpy(), x.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_registered_transform_takes_the_composed_path():
    """A transform added by ``register`` has no kernel id: the builder
    builds that feature with the composed operations, counted as such,
    and the other features through the op."""
    ttr.register(ttr.Transform(
        "half", lambda x: x / 2, lambda x: x * 2, ttr._finite))
    try:
        raw = case_raw("half", "zscore", "spatial", True)
        bindings = tparse_bindings(raw)
        fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
        batch = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
        before = dict(fbk.feature_build.builds)
        x, m = fb.build_feature("case", batch)
        fb.build_feature("type_encoder_input", batch)
        assert fbk.feature_build.builds == {
            "kernel": before["kernel"] + 1,
            "composed": before["composed"] + 1}
        # the same build with the half taken before the transform-free path
        raw2 = case_raw("none", "zscore", "spatial", True)
        fb2 = TFB(tparse_bindings(raw2), fb.stats)
        halved = dict(batch, static=batch["static"].clone())
        halved["static"][..., 0] /= 2
        x2, m2 = fb2.build_feature("case", halved)
        assert torch.equal(m, m2)
        np.testing.assert_allclose(x.numpy(), x2.numpy(), rtol=1e-6,
                                   atol=1e-6)
    finally:
        del ttr._REGISTRY["half"]


@pytest.mark.parametrize("whiten", [False, True])
def test_op_counts_the_whitening_product(whiten):
    """The op's FLOPs are the whitening product's 2 rows C^2, what
    FlopCounterMode counted for the einsum of the composed build."""
    from torch.utils.flop_counter import FlopCounterMode
    bindings = tparse_bindings(case_raw("sqrt", "zscore", "spatial_to_t",
                                         whiten))
    fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
    batch = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    coords = torch.from_numpy(COORDS)
    plan = fb._plan("case")
    w, mu = fb._table("case", plan, torch.device("cpu"))[2:]
    for build, rows in ((lambda: fb.build_feature("case", batch),
                         2 * 5 * 12 * 12),
                        (lambda: fb.build_feature_at_locations(
                            "case", batch, coords), 2 * 5 * 5)):
        with FlopCounterMode(display=False) as counter:
            build()
        assert counter.get_total_flops() == (2 * rows * 9 if whiten else 0)
        if whiten:
            with FlopCounterMode(display=False) as counter:
                fbk.compose([batch[g] for g in plan.groups], plan.channels,
                            w, mu, True, 5.0,
                            None if rows == 1440 else coords)
            assert counter.get_total_flops() == 2 * rows * 9


@pytest.mark.parametrize("width,whiten,refused", [
    (fbk.MAX_CHANNELS, False, False),
    (fbk.MAX_CHANNELS + 1, False, True),
    (fbk.MAX_WHITENED_CHANNELS, True, False),
    (fbk.MAX_WHITENED_CHANNELS + 1, True, True)])
def test_features_wider_than_the_kernel_take_the_composed_path(width, whiten,
                                                               refused):
    """A feature of any width is built on the CPU by the op's plain
    version, the composed build; the kernel's arguments refuse one wider
    than the kernel takes, so that the op raises on a card."""
    raw = synthetic_bindings(NOWHERE / "cube.zarr", NOWHERE / "none.json")
    raw["dataset"]["big"] = {"type": "float32", "dim": ["C", "H", "W"],
                             "channels": [{"name": f"c{k}", "source": "v"}
                                          for k in range(width)]}
    raw["features"]["big"] = {"dim": ["C", "H", "W"], "channels": {
        f"big.c{k}": {"norm": "zscore"} for k in range(width)},
        "covariance": {"calculate": whiten}}
    stats = {"big": {"__covariance__": {"matrix": np.eye(width).tolist()}}}
    fb = TFB(tparse_bindings(raw), stats)
    before = dict(fbk.feature_build.builds)
    groups = {"big": torch.ones(1, 2, 2, width)}
    x, m = fb.build_feature("big", groups)
    assert fbk.feature_build.builds == dict(before,
                                            kernel=before["kernel"] + 1)
    assert x.shape == (1, 2, 2, width) and bool(m.all())
    itab, ftab, w, mu = fb._table("big", fb._plan("big"),
                                  torch.device("cpu"))
    if refused:
        with pytest.raises(ValueError, match="channels"):
            fbk.kernel_args([groups["big"]], itab, ftab, w, mu, None, False,
                            5.0)
    else:
        fbk.kernel_args([groups["big"]], itab, ftab, w, mu, None, False, 5.0)


@pytest.mark.parametrize("what", ["dtype", "groups", "coords"])
def test_kernel_arguments_refuse_what_the_kernel_lacks(what):
    """A group dtype outside DTYPE_CODES, more groups than the kernel
    takes, coords that are not int32 or int64: refused, not built by
    another path."""
    bindings = tparse_bindings(case_raw("sqrt", "zscore", "spatial", False))
    fb = TFB(bindings, stats_for(bindings.features["case"], "case"))
    plan = fb._plan("case")
    batch = {k: torch.from_numpy(v) for k, v in case_batch_np().items()}
    gl = [batch[g] for g in plan.groups]
    itab, ftab, w, mu = fb._table("case", plan, gl[0].device)
    coords = None
    if what == "dtype":
        gl[0] = gl[0].to(torch.complex64)
        err = TypeError
    elif what == "groups":
        gl = gl + [gl[-1]] * fbk.MAX_GROUPS
        err = ValueError
    else:
        coords = torch.from_numpy(COORDS).to(torch.int16)
        err = TypeError
    with pytest.raises(err):
        fbk.kernel_args(gl, itab, ftab, w, mu, coords, False, 5.0)
