"""forest_tpu_torch feature assembly against forest_tpu's.

``FeatureBuilder.build_feature`` on a seeded ``synthetic_frl_batch`` with
injected NaNs and zeroed masks, for the spatial ``type_encoder_input`` and
the temporal ``phase_ccdc`` (spatial -> temporal mask broadcast), both with
Mahalanobis whitening under a random SPD covariance, and with log / sqrt
pre-transforms on some channels. Transforms and whitening are also held to
the JAX functions one by one.

Tolerance: float32 rtol 1e-5 / atol 1e-5 (whitening is a C x C matmul,
summed in another order); masks must be equal.
"""
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
from forest_tpu_torch.data.feature_builder import FeatureBuilder as TFB
from forest_tpu_torch.ops import whitening as twh
from torch_parity import t

F32 = dict(rtol=1e-5, atol=1e-5)


def _bindings(tmp_path):
    raw = synthetic_bindings(tmp_path / "cube.zarr", tmp_path / "none.json")
    chans = raw["features"]["type_encoder_input"]["channels"]
    chans["static.slope"]["transform"] = {"name": "log", "epsilon": 0.5}
    chans["static.variance_ndvi"]["transform"] = "sqrt"
    raw["features"]["type_encoder_input"]["covariance"] = {
        "calculate": True}
    return parse_bindings(raw)


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
    x, m = TFB(bindings, stats).build_feature(
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
