"""The step diagnostics of forest_tpu_torch against the JAX package's.

``masked_stats``, ``tau_sweep_stats`` and ``type_leakage_ridge`` of both
packages (the JAX ones jitted) on the same seeded numpy inputs on the CPU.
Tolerance: float32, 1e-5 relative (1e-4 for the ridge R^2, a linear solve
whose pivoting differs between LAPACK's and XLA's).
"""
import jax
import numpy as np
import pytest
import torch

from forest_tpu.training.representation import diagnostics as jdg
from forest_tpu_torch.training.representation import diagnostics as tdg
from torch_parity import t


def close(got, ref, rtol=1e-5):
    assert set(got) == set(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(float(got[key]), float(val), rtol=rtol,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("shape,frac", [((4, 30, 7), 0.6), ((500,), 0.05),
                                        ((3, 5), 0.0)])
def test_masked_stats(shape, frac):
    """``frac`` 0: no valid entry, NaN quantiles in both."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    valid = rng.random(shape) < frac
    ref = jax.jit(jdg.masked_stats, static_argnums=2)(x, valid, "p")
    got = tdg.masked_stats(t(x), torch.from_numpy(valid), "p")
    if frac == 0.0:
        assert all(np.isnan(float(got[k])) == np.isnan(float(ref[k]))
                   for k in ref)
        assert np.isnan(float(got["p_p50"]))
        ref = {k: v for k, v in ref.items() if not np.isnan(float(v))}
        got = {k: got[k] for k in ref}
    close(got, ref)


def test_masked_stats_broadcasts_the_mask():
    rng = np.random.default_rng(7)
    x = rng.random((2, 6, 6, 5)).astype(np.float32)
    m = rng.random((2, 6, 6, 1)) > 0.3
    ref = jax.jit(jdg.masked_stats, static_argnums=2)(
        x, np.broadcast_to(m, x.shape), "g")
    close(tdg.masked_stats(t(x), torch.from_numpy(m), "g"), ref)


@pytest.mark.parametrize("negate", [False, True])
def test_tau_sweep_stats(negate):
    rng = np.random.default_rng(8)
    d = (rng.random((12, 40, 8)) * 30).astype(np.float32)
    valid = rng.random(d.shape) > 0.4
    ref = jax.jit(jdg.tau_sweep_stats, static_argnums=(2, 3, 4))(
        d, valid, 0.05, "tau", negate)
    got = tdg.tau_sweep_stats(t(d), torch.from_numpy(valid), 0.05, "tau",
                              negate)
    assert len(got) == 3 * len(tdg.TAU_SWEEP)
    close(got, ref)


@pytest.mark.parametrize("leak", [0.0, 0.8])
def test_type_leakage_ridge(leak):
    rng = np.random.default_rng(9)
    n = 400
    z = rng.normal(size=(n, 6)).astype(np.float32)
    h = rng.normal(size=(n, 3)).astype(np.float32)
    h[:, 0] += leak * z[:, 2]
    valid = rng.random(n) > 0.25
    ref = jax.jit(jdg.type_leakage_ridge)(h, z, valid)
    got = tdg.type_leakage_ridge(t(h), t(z), torch.from_numpy(valid))
    close(got, ref, rtol=1e-4)
    assert (float(got["leak_r2_max"]) > 0.2) == (leak > 0)
