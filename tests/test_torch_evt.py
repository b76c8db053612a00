"""The EVT soft-neighbourhood loss of forest_tpu_torch against the JAX one.

The diffusion metric from a confusion CSV written in ``tmp_path`` (with a
LANDFIRE-style summary row and column, which both loaders drop), its lookup
tables (``step.build_evt_tables``), and the loss with its gradient, on the
same seeded numpy inputs on the CPU; the JAX loss runs jitted.

Tolerance: the metric's arrays equal (both are numpy in float64, stored as
float32); the loss 1e-5 relative; its gradient 1e-4 of the largest
magnitude.
"""
import jax
import numpy as np
import pytest
import torch

from forest_tpu.losses import evt_soft_neighborhood as jevt
from forest_tpu.training.representation import step as jstep
from forest_tpu_torch.losses import evt_soft_neighborhood as tevt
from forest_tpu_torch.training.representation import step as tstep
from torch_parity import t, ti

CODES = (7001, 7002, 7005, 7010, 7011)
COUNTS = {7001: 900, 7002: 400, 7005: 150, 7010: 60, 7011: 5}


@pytest.mark.parametrize("opts", [
    {}, {"laplace_smoothing": 1.0, "diffusion_steps": 3},
    {"binary_threshold": 0.05, "min_confusion_samples": 0},
    {"min_count": 1000}])
def test_diffusion_metric_and_tables(opts, tmp_path):
    path = tevt.write_synthetic_confusion_csv(tmp_path / "conf.csv", CODES,
                                              seed=1)
    kw = dict({"min_count": 10}, **opts)
    if kw["min_count"] > 900:
        for mod in (jevt, tevt):
            with pytest.raises(ValueError, match="fewer than 2"):
                mod.EvtDiffusionMetric(path, COUNTS, **kw)
        return
    ref = jevt.EvtDiffusionMetric(path, COUNTS, **kw)
    got = tevt.EvtDiffusionMetric(path, COUNTS, **kw)
    assert got.n_codes == ref.n_codes == 4          # 7011: too few pixels
    np.testing.assert_array_equal(got.codes, ref.codes)
    np.testing.assert_array_equal(got.similarity, ref.similarity)
    np.testing.assert_array_equal(got.freq_weights, ref.freq_weights)
    assert got.code_to_idx == ref.code_to_idx
    raw = np.array([7001, 7003, 7010, 7011, 7002, 0])
    for a, b in zip(got.lookup(raw), ref.lookup(raw)):
        np.testing.assert_array_equal(a, b)
    tt, jt = tstep.build_evt_tables(got), jstep.build_evt_tables(ref)
    assert set(tt) == set(jt) and tt["code_offset"] == jt["code_offset"]
    for key in ("similarity", "idx_lut", "valid_lut", "weight_lut"):
        np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)


def test_confusion_csv_loader_drops_summaries(tmp_path):
    path = tevt.write_synthetic_confusion_csv(tmp_path / "conf.csv", CODES,
                                              seed=2)
    m, codes = tevt._load_confusion_csv(path)
    rm, rcodes = jevt._load_confusion_csv(path)
    assert codes == rcodes == list(CODES)
    np.testing.assert_array_equal(m, rm)
    assert m.shape == (5, 5)


@pytest.mark.parametrize("n_valid", [60, 3])
def test_evt_loss_and_grad(n_valid, tmp_path):
    """``n_valid`` 3 is below ``min_valid_anchors``: the loss is 0."""
    path = tevt.write_synthetic_confusion_csv(tmp_path / "conf.csv", CODES,
                                              seed=3)
    metric = jevt.EvtDiffusionMetric(path, COUNTS, min_count=10)
    rng = np.random.default_rng(n_valid)
    n = 80
    codes = rng.choice(np.array(CODES + (7020,)), n)
    idx, valid, w = metric.lookup(codes)
    valid &= np.arange(n) < n_valid
    emb = rng.normal(size=(n, 6)).astype(np.float32)

    def jloss(e):
        return jevt.evt_soft_neighborhood_loss(
            e, idx, valid, w, metric.similarity, codes.astype(np.int32), 0.4,
            0.6, 4)

    (ref, rstats), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        emb)
    te = t(emb).requires_grad_(True)
    loss, stats = tevt.evt_soft_neighborhood_loss(
        te, ti(idx), torch.from_numpy(valid), t(w),
        torch.from_numpy(metric.similarity), ti(codes), 0.4, 0.6, 4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5,
                               atol=1e-7)
    for key, val in rstats.items():
        np.testing.assert_allclose(float(stats[key]), float(val),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    r = np.asarray(rgrad)
    np.testing.assert_allclose(te.grad.numpy(), r, rtol=1e-4,
                               atol=1e-4 * max(np.abs(r).max(), 1e-30))
    assert (float(ref) > 0) == (n_valid >= 4)
