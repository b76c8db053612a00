"""The phase losses of forest_tpu_torch against the JAX package's.

``ops.topk``, ``losses.phase_pairs``, ``losses.soft_neighborhood``,
``losses.phase_neighborhood`` and ``losses.triplet_phase`` of both packages
on the same seeded numpy inputs on the CPU, at the tiny sizes of the step
tests (T = 15, a few hundred anchors); the JAX functions run jitted.
The port's one sample-grouped neighbourhood builder is held to both JAX
builders (the flat one and the sample-grouped one in its ``mnsp`` layout,
the one the JAX train step runs) through ``phase_neighborhood_loss``.

Tolerance: float32 values 1e-5 relative; gradients (``jax.grad`` against
``torch.autograd``) 1e-4 of the tensor's largest magnitude.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forest_tpu.losses import phase_neighborhood as jpn
from forest_tpu.losses import phase_pairs as jpp
from forest_tpu.losses import soft_neighborhood as jsn
from forest_tpu.losses import triplet_phase as jtp
from forest_tpu.ops import topk as jtopk
from forest_tpu_torch.losses import phase_neighborhood as tpn
from forest_tpu_torch.losses import phase_pairs as tpp
from forest_tpu_torch.losses import soft_neighborhood as tsn
from forest_tpu_torch.losses import triplet_phase as ttp
from forest_tpu_torch.ops import topk as ttopk
from torch_parity import cuda_device, t, ti  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-6)
T_STEPS, NUM_CLASSES = 15, 64


def grad_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def ysfc_series(rng, n, t=T_STEPS, nan_frac=0.0):
    """Years since the last disturbance: a start in [0, 20), +1 a year,
    back to 0 at a disturbance (15 % a year); NaN at ``nan_frac`` of the
    entries."""
    y = np.zeros((n, t), np.float32)
    y[:, 0] = rng.integers(0, 20, n)
    for k in range(1, t):
        y[:, k] = np.where(rng.random(n) < 0.15, 0.0, y[:, k - 1] + 1.0)
    y[rng.random((n, t)) < nan_frac] = np.nan
    return y


# --- ops.topk ---------------------------------------------------------------

def test_top_k_order_and_ties_match_lax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    x[x == 0] = -np.inf
    x[:, 5] = np.inf
    ref_v, ref_i = jax.jit(jax.lax.top_k, static_argnums=1)(x, 12)
    v, i = ttopk.top_k(t(x), 12)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("n", [300, 5000])
def test_topk_maybe_approx_is_exact(n):
    """Above ``exact_below`` JAX takes ``lax.approx_max_k``, which is exact
    off the TPU: the same indices as the port's exact top-k."""
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    f = jax.jit(partial(jtopk.topk_maybe_approx, k=20))
    ref_v, ref_i = f(x)
    v, i = ttopk.topk_maybe_approx(t(x), 20)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


# --- losses.phase_pairs -----------------------------------------------------

def test_ysfc_overlap_matrix():
    y = ysfc_series(np.random.default_rng(1), 40, nan_frac=0.1)
    y[0, :3] = [-1.0, 70.0, 3.0]                  # out of range: ignored
    ref = jax.jit(jpp.ysfc_overlap_matrix, static_argnums=1)(y, NUM_CLASSES)
    got = tpp.ysfc_overlap_matrix(t(y), NUM_CLASSES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("masked", [False, True])
def test_build_phase_pairs(masked):
    """Two samples in one call (leading batch axis) against two JAX calls."""
    rng = np.random.default_rng(2 + masked)
    s, n = 2, 60
    spec = rng.normal(size=(s, n, 5)).astype(np.float32)
    ysfc = np.stack([ysfc_series(rng, n) for _ in range(s)])
    va = rng.random((s, n)) > 0.2 if masked else None
    f = jax.jit(partial(jpp.build_phase_pairs, k=8, min_overlap=3,
                        min_pairs=3, sigma=5.0, num_ysfc_classes=NUM_CLASSES))
    pairs, w, v, stats = tpp.build_phase_pairs(
        t(spec), t(ysfc), 8, 3, 3, True, 5.0,
        num_ysfc_classes=NUM_CLASSES,
        valid_anchors=None if va is None else torch.from_numpy(va))
    for i in range(s):
        rp, rw, rv, rs = f(spec[i], ysfc[i],
                           valid_anchors=None if va is None else va[i])
        np.testing.assert_array_equal(pairs[i].numpy(), np.asarray(rp))
        np.testing.assert_array_equal(v[i].numpy(), np.asarray(rv))
        np.testing.assert_allclose(w[i].numpy(), np.asarray(rw), **VAL)
        for key, val in stats.items():
            np.testing.assert_allclose(val[i].numpy(), np.asarray(rs[key]),
                                       err_msg=key, **VAL)
        assert np.asarray(rv).sum() > n


# --- losses.soft_neighborhood -----------------------------------------------

def test_soft_neighborhood_matching_loss_and_grad():
    rng = np.random.default_rng(3)
    b, m = 30, 9
    d_ref = rng.random((b, m, m)).astype(np.float32) * 3
    d_lrn = rng.random((b, m, m)).astype(np.float32) * 3
    mask = rng.random((b, m, m)) > 0.3
    mask[:4] = False                                # fully masked pairs
    mask[4, :, 1:] = False                          # rows below min_valid
    w = rng.random(b).astype(np.float32)

    def jloss(dl):
        return jsn.soft_neighborhood_matching_loss(d_ref, dl, mask, 0.1,
                                                   0.2, w, 2)

    (ref, rstats), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        d_lrn)
    dl = t(d_lrn).requires_grad_(True)
    loss, stats = tsn.soft_neighborhood_matching_loss(
        t(d_ref), dl, torch.from_numpy(mask), 0.1, 0.2, t(w), 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **VAL)
    for key, val in rstats.items():
        np.testing.assert_allclose(float(stats[key]), float(val),
                                   err_msg=key, **VAL)
    grad_close(dl.grad, rgrad)
    with pytest.raises(ValueError):
        tsn.soft_neighborhood_matching_loss(t(d_ref), dl,
                                            torch.from_numpy(mask),
                                            min_valid_per_row=1)


def test_pairwise_sq_distances():
    x = np.random.default_rng(4).normal(size=(3, 12, 6)).astype(np.float32)
    ref = jax.jit(jsn.pairwise_sq_distances)(x)
    np.testing.assert_allclose(tsn.pairwise_sq_distances(t(x)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- losses.phase_neighborhood: alignment helpers ---------------------------

def test_seq_lengths_and_best_t():
    y = ysfc_series(np.random.default_rng(5), 50, nan_frac=0.05)
    y[0, 0] = np.nan                      # a series that starts with NaN
    y[1] = [3, 4, 0, 1, 2, 0, 1, 2, 3, 4, 5, 0, 1, 2, 3]
    np.testing.assert_array_equal(
        tpn.seq_lengths_per_t(t(y)).numpy(),
        np.asarray(jax.jit(jpn.seq_lengths_per_t)(y)))
    pres, best = tpn._presence_and_best_t(t(y), NUM_CLASSES)
    rpres, rbest = jax.jit(jpn._presence_and_best_t, static_argnums=1)(
        y, NUM_CLASSES)
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rpres))
    np.testing.assert_array_equal(best.numpy(), np.asarray(rbest))


# --- losses.phase_neighborhood: the builder and its losses ------------------

def neighborhood_inputs(seed, s=2, a=40, c=4, d=3, self_pairs=True):
    rng = np.random.default_rng(seed)
    spec = rng.normal(size=(s, a, T_STEPS, c)).astype(np.float32)
    phase = rng.normal(size=(s, a, T_STEPS, d)).astype(np.float32)
    ysfc = np.stack([ysfc_series(rng, a) for _ in range(s)])
    p = 6 * a
    pairs = np.stack([rng.integers(0, a, size=(p, 2)) for _ in range(s)])
    if self_pairs:
        pairs[:, :a, 1] = pairs[:, :a, 0]
    else:
        pairs[..., 1] = np.where(pairs[..., 0] == pairs[..., 1],
                                 (pairs[..., 1] + 1) % a, pairs[..., 1])
    pvalid = rng.random((s, p)) > 0.1
    pw = rng.random((s, p)).astype(np.float32)
    dyn = rng.normal(size=(s * a,)).astype(np.float32)
    return spec, phase, ysfc, pairs, pvalid, pw, dyn


@pytest.mark.parametrize("jax_builder", ["flat", "mnsp"])
def test_phase_neighborhood_loss_matches_both_jax_builders(jax_builder):
    """The flat JAX builder takes distances by the expansion |a|^2 - 2 a.b +
    |b|^2, which leaves rounding where a self pair's cross distances are
    zero; the square root's gradient magnifies it there. Its case has no
    self pairs; the ``mnsp`` builder's (the train step's) has them."""
    spec, phase, ysfc, pairs, pvalid, pw, _ = neighborhood_inputs(
        6, self_pairs=jax_builder == "mnsp")
    s, a, t_, c = spec.shape
    offs = (np.arange(s) * a)[:, None, None]
    flat_pairs = (pairs + offs).reshape(-1, 2)
    kw = dict(tau_ref=0.1, tau_learned=0.1, min_overlap=3,
              min_valid_per_row=2, self_similarity_weight=1.0,
              cross_pixel_weight=0.7, num_classes=NUM_CLASSES)

    def jloss(ph):
        if jax_builder == "flat":
            return jpn.phase_neighborhood_loss(
                jnp.asarray(spec.reshape(s * a, t_, c)),
                ph.reshape(s * a, t_, -1),
                ysfc.reshape(s * a, t_), flat_pairs, pw.reshape(-1),
                pvalid.reshape(-1), **kw)
        batch = jpn.build_phase_neighborhood_batch_grouped(
            spec, ph, ysfc, pairs, pvalid, 3, NUM_CLASSES, layout="mnsp")
        return jpn.phase_neighborhood_loss(
            spec.reshape(s * a, t_, c), ph.reshape(s * a, t_, -1),
            ysfc.reshape(s * a, t_), flat_pairs, pw.reshape(-1),
            pvalid.reshape(-1), _batch=batch, **kw)

    (ref, rstats), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        phase)
    ph = t(phase).requires_grad_(True)
    batch = tpn.build_phase_neighborhood_batch(
        t(spec), ph, t(ysfc), ti(pairs), torch.from_numpy(pvalid), 3,
        NUM_CLASSES)
    np.testing.assert_array_equal(batch["pair_index"].numpy(), flat_pairs)
    loss, stats = tpn.phase_neighborhood_loss(
        batch, t(pw).reshape(-1), 0.1, 0.1, 2, 1.0, 0.7)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **VAL)
    for key in ("n_pairs_input", "n_pairs_sufficient_overlap", "loss_self",
                "loss_cross", "self_n_rows_valid", "cross_mean_entropy_p",
                "cross_mean_entropy_q", "self_mean_overlap"):
        np.testing.assert_allclose(float(stats[key]), float(rstats[key]),
                                   err_msg=key, **VAL)
    assert int(stats["n_pairs_sufficient_overlap"]) > 100
    grad_close(ph.grad, rgrad)


def test_phase_spread_ranking():
    spec, phase, ysfc, pairs, pvalid, _, dyn = neighborhood_inputs(7)
    s, a = spec.shape[:2]
    flat_pairs = (pairs + (np.arange(s) * a)[:, None, None]).reshape(-1, 2)

    def jloss(ph):
        batch = jpn.build_phase_neighborhood_batch_grouped(
            spec, ph, ysfc, pairs, pvalid, 3, NUM_CLASSES, layout="mnsp")
        return jpn.compute_phase_spread_ranking(batch, flat_pairs, dyn, 0.1,
                                                0.5)

    (ref, rstats), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        phase)
    ph = t(phase).requires_grad_(True)
    batch = tpn.build_phase_neighborhood_batch(
        t(spec), ph, t(ysfc), ti(pairs), torch.from_numpy(pvalid), 3,
        NUM_CLASSES)
    loss, stats = tpn.compute_phase_spread_ranking(
        batch, batch["pair_index"], t(dyn), 0.1, 0.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **VAL)
    for key, val in rstats.items():
        np.testing.assert_allclose(float(stats[key]), float(val),
                                   err_msg=key, **VAL)
    assert int(stats["n_constrained_i"]) + int(stats["n_constrained_j"]) > 0
    grad_close(ph.grad, rgrad)


@pytest.mark.parametrize("n", [300, 1100])
def test_type_local_spectral_demean(n):
    """Exact top-k below 1024 rows in JAX, ``approx_max_k`` above (exact
    off the TPU): the same neighbours and baselines either way."""
    rng = np.random.default_rng(n)
    z = rng.normal(size=(n, 8)).astype(np.float32)
    z[:, 6:] = z[:, :2] * 0.5                  # rank 6 < 8: floored lambdas
    spec = rng.normal(size=(n, T_STEPS, 4)).astype(np.float32)
    valid = rng.random(n) > 0.15
    f = jax.jit(jpn.type_local_spectral_demean, static_argnums=(3, 4))
    rdm, rhat = f(z, spec, valid, 4, 20)
    dm, hat = tpn.type_local_spectral_demean(t(z), t(spec),
                                             torch.from_numpy(valid), 4, 20)
    np.testing.assert_allclose(hat.numpy(), np.asarray(rhat), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dm.numpy(), np.asarray(rdm), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_type_local_spectral_demean_on_card(cuda_device):
    """The card's branch (the Gram copied to the host for ``eigh``, the
    basis back from pinned memory) against the CPU's, at the full step's N
    of 12 x 300 anchors, D 48 and the step's PCA rank 8 and k 20. z has a
    clear rank-8 part, so the basis is well defined on both. A valid row
    whose 20th and 21st similarity (float64) lie closer than 1e-5 of its
    largest may take either neighbour in float32; every other row (an
    invalid one has exact zeros, broken by index on both) is held at 1e-5,
    and they must be 99 % of the rows."""
    n, d, pca, k = 3600, 48, 8, 20
    rng = np.random.default_rng(36)
    z = (rng.normal(size=(n, pca)) @ rng.normal(size=(pca, d))
         + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    spec = rng.normal(size=(n, T_STEPS, 7)).astype(np.float32)
    valid = rng.random(n) > 0.15
    dm, hat = tpn.type_local_spectral_demean(t(z), t(spec),
                                             torch.from_numpy(valid), pca, k)
    gdm, ghat = tpn.type_local_spectral_demean(
        t(z).to(cuda_device), t(spec).to(cuda_device),
        torch.from_numpy(valid).to(cuda_device), pca, k)
    torch.cuda.synchronize()
    # the neighbour margin of every row, in float64
    v = valid[:, None].astype(np.float64)
    zc = (z - (z * v).sum(0) / v.sum()) * v
    lam, vec = np.linalg.eigh(zc.T @ zc)
    u = zc @ vec[:, -pca:] / np.sqrt(lam[-pca:])
    sim = u @ u.T
    np.fill_diagonal(sim, -np.inf)
    sim[:, ~valid] = -np.inf
    top = -np.sort(-sim, axis=1)[:, :k + 1]
    clear = ((top[:, k - 1] - top[:, k]) > 1e-5 * np.abs(top[:, 0])) | ~valid
    assert clear.mean() > 0.99, clear.mean()
    np.testing.assert_allclose(ghat.cpu().numpy()[clear], hat.numpy()[clear],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gdm.cpu().numpy()[clear], dm.numpy()[clear],
                               rtol=1e-5, atol=1e-5)


# --- losses.triplet_phase ---------------------------------------------------

def test_classify_triplet_batch():
    y = ysfc_series(np.random.default_rng(8), 200)
    for t0, t1, t2 in ((0, 5, 10), (2, 3, 4), (1, 7, 14)):
        ref = jax.jit(jtp.classify_triplet_batch, static_argnums=(1, 2, 3))(
            y, t0, t1, t2)
        got = ttp.classify_triplet_batch(t(y), t0, t1, t2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        # adjacent years leave no interval for a disturbance
        assert len(np.unique(np.asarray(ref))) == (2 if t1 == t0 + 1 else 4)


def test_phase_triplet_loss_and_grad():
    rng = np.random.default_rng(9)
    n = 200
    y = ysfc_series(rng, n)
    e = [rng.normal(size=(n, 5)).astype(np.float32) for _ in range(3)]

    def jloss(e0, e1, e2):
        return jtp.phase_triplet_loss(e0, e1, e2, y, 1, 6, 12, 1.0, 0.3)

    (ref, rstats), rgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*e)
    te = [t(x).requires_grad_(True) for x in e]
    loss, stats = ttp.phase_triplet_loss(*te, t(y), 1, 6, 12, 1.0, 0.3)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **VAL)
    for key, val in rstats.items():
        np.testing.assert_allclose(float(stats[key]), float(val),
                                   err_msg=key, **VAL)
    for g, r in zip(te, rgrads):
        grad_close(g.grad, r)


def test_recovery_discrimination_loss_and_grad_as_the_step_feeds_it():
    """Invalid anchors as the step masks them: z zeroed, ysfc NaN. Coincident
    embeddings (the zeroed rows, and a series whose low and high years
    share an embedding) keep every gradient finite."""
    rng = np.random.default_rng(10)
    n = 120
    y = ysfc_series(rng, n, nan_frac=0.05)
    z = rng.normal(size=(n, T_STEPS, 4)).astype(np.float32)
    valid = rng.random(n) > 0.2
    y[3] = [0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4, 5, 6, 7]
    z[3, 1] = z[3, 5]                              # d = 0 at a live pair
    y_in = np.where(valid[:, None], y, np.nan)

    def jloss(zz):
        zz = jnp.where(valid[:, None, None], zz, 0.0)
        return jtp.phase_recovery_discrimination_loss(zz, y_in, 0.5, 1.0,
                                                      5.0)

    (ref, rstats), rgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        z)
    tz = t(z).requires_grad_(True)
    vt = torch.from_numpy(valid)[:, None, None]
    loss, stats = ttp.phase_recovery_discrimination_loss(
        torch.where(vt, tz, torch.zeros_like(tz)), t(y_in), 0.5, 1.0, 5.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **VAL)
    for key, val in rstats.items():
        assert int(stats[key]) == int(val), key
    assert torch.isfinite(tz.grad).all()
    assert not tz.grad[~torch.from_numpy(valid)].any()
    grad_close(tz.grad, rgrad)
